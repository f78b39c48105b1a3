"""``TransformerRecognizer.generate``'s two decode paths: the one greedy
step replayed as CUDA graphs (``runtime/trocr_runtime.py:GraphedDecode``)
on the card, called eagerly elsewhere. The card's tests compare the
graphs with the eager ``greedy_generate`` on the same model; the step's
arithmetic is held against ``vtd_tpu`` on the CPU in
``test_torch_trocr.py``. This file imports no JAX, so the card's
machine runs it: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_trocr_graph.py``.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _count(path):
    from vtd_tpu_torch.obs import metrics

    return metrics.trocr_decode_chunks_total.labels(path=path)._value


def _images(cfg, n, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, cfg.image_size, cfg.width, 3), generator=gen) * 2 - 1
    return x.to(device)


def test_cpu_chunks_take_the_eager_loop():
    from vtd_tpu_torch.models.trocr import greedy_generate, small_config
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    cfg = small_config(image_size=32, image_width=64, max_len=6)
    rec = TransformerRecognizer(config=cfg, seed=2, device="cpu",
                                pad_batch=4)
    x = _images(cfg, 3, 0, "cpu")
    eager, graph = _count("eager"), _count("graph")
    toks, confs = rec.generate(x)
    assert _count("eager") - eager == 1 and _count("graph") == graph
    want_t, want_c = greedy_generate(rec.model, x)
    assert torch.equal(toks, want_t) and torch.equal(confs, want_c)
    assert rec._graphed is None  # nothing built off the card


@pytest.fixture(scope="module")
def card_recognizer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only there")
    from vtd_tpu_torch.models.trocr import small_config
    from vtd_tpu_torch.runtime.trocr_runtime import TransformerRecognizer

    cfg = small_config(image_size=32, image_width=96, dec_layers=3,
                       max_len=16)
    return TransformerRecognizer(config=cfg, seed=7, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,path", [(1, "graph"), (5, "graph"),
                                    (16, "graph"), (17, "eager")])
def test_graphed_generate_matches_eager(card_recognizer, n, path):
    """Chunks of 1 to ``pad_batch`` (16) crops replay graphs, a larger
    one takes the eager loop; the tokens are the eager loop's either way,
    and each chunk is counted under its path."""
    from vtd_tpu_torch.models.trocr import greedy_generate

    rec = card_recognizer
    x = _images(rec.cfg, n, n, "cuda")
    before = _count(path)
    toks, confs = rec.generate(x)
    assert _count(path) - before == 1
    if path == "graph":
        assert len(rec._graphed.graphs) == rec.pad_batch
    want_t, want_c = greedy_generate(rec.model, x)
    assert toks.shape == (n, rec.cfg.max_len) and toks.dtype == torch.int32
    assert torch.equal(toks, want_t)
    np.testing.assert_allclose(confs.cpu().numpy(), want_c.cpu().numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_back_to_back_chunks_keep_their_own(card_recognizer):
    """Two chunks of one size enqueued before either is read (as the
    pipeline's ``_decode_chunks`` does) return their own results, not
    views of the one set of static buffers."""
    from vtd_tpu_torch.models.trocr import greedy_generate

    rec = card_recognizer
    xs = [_images(rec.cfg, 5, seed, "cuda") for seed in (21, 22)]
    outs = [rec.generate(x) for x in xs]
    got = [(t.cpu(), c.cpu()) for t, c in outs]
    assert not torch.equal(got[0][0], got[1][0])
    for x, (toks, confs) in zip(xs, got):
        want_t, want_c = greedy_generate(rec.model, x)
        assert torch.equal(toks, want_t.cpu())
        np.testing.assert_allclose(confs.numpy(), want_c.cpu().numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_replicas_hold_separate_graphs(card_recognizer):
    rec = card_recognizer
    x = _images(rec.cfg, 3, 31, "cuda")
    want = rec.generate(x)
    rep = rec.replica("cuda")
    assert rep._graphed is None and rep._lock is not rec._lock
    before = _count("graph")
    got = rep.generate(x)
    assert _count("graph") - before == 1
    assert rep._graphed and rep._graphed is not rec._graphed
    assert set(g.pool() for g in rep._graphed.graphs).isdisjoint(
        g.pool() for g in rec._graphed.graphs)
    assert (rep._graphed.state.toks.data_ptr()
            != rec._graphed.state.toks.data_ptr())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_split_model_keeps_the_eager_loop(card_recognizer):
    rec = card_recognizer
    split = rec.replica(["cuda", "cuda"], min_size=16)
    x = _images(rec.cfg, 4, 41, "cuda")
    before = _count("eager")
    got = split.generate(x)
    assert _count("eager") - before == 1 and split._graphed is False
    assert torch.equal(got[0], rec.generate(x)[0])


@pytest.mark.cuda
def test_profiler_links_graph_kernels_to_the_caller(card_recognizer):
    """A profiler attributes the replayed graphs' kernels to the range
    that called ``generate``, as it does eager kernels: all of the card's
    work in a profile of one graphed chunk falls under that range, not
    only the encoder's."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    rec = card_recognizer
    x = _images(rec.cfg, 8, 51, "cuda")
    rec.generate(x)
    torch.cuda.synchronize()
    before = _count("graph")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("probe.graph"):
            rec.generate(x)
        torch.cuda.synchronize()
    assert _count("graph") - before == 1
    under = sum(ev.device_time_total for ev in prof.events()
                if ev.name == "probe.graph") * 1e3
    total = sum(ev.duration_ns()
                for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == DeviceType.CUDA
                and not ev.name().startswith("probe."))
    assert total > 0
    assert under >= 0.95 * total, (under, total)


@pytest.mark.cuda
@pytest.mark.parametrize("n,path", [(16, "graph"), (17, "eager")])
def test_chunks_count_their_attention_launches(card_recognizer, n, path):
    """Every decode step runs the attention kernel twice a decoder layer
    (self- and cross-attention) on both paths; a graph's launches are
    counted at each replay, not at its capture."""
    from vtd_tpu_torch.ops.decode_attention import decode_attention

    rec = card_recognizer
    cfg = rec.cfg
    x = _images(cfg, n, 61, "cuda")
    rec.generate(x[:1])  # the graphs are captured by now
    assert rec._graphed.launches == [2 * cfg.dec_layers] * rec.pad_batch
    before, chunks = decode_attention.launches, _count(path)
    rec.generate(x)
    torch.cuda.synchronize()
    assert _count(path) - chunks == 1
    assert decode_attention.launches - before == (
        2 * cfg.dec_layers * cfg.max_len)
