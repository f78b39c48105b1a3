"""``ops/decode_attention.py``: one query token's attention over a cached
K/V, the TrOCR decoder's step. On the CPU the op is the plain version,
held bit for bit against ``Attention.forward``'s arithmetic, and the
decode loop built on it against the same loop through
``Attention.forward``. On the card the kernel is held against the plain
version at the main path's shapes. This file imports no JAX, so the
card's machine runs it: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_decode_attention.py``.
"""
import pytest
import torch

from vtd_tpu_torch.models import trocr
from vtd_tpu_torch.ops import decode_attention as op

torch.set_num_threads(2)


def _kv(b, t, h, hd, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(device)
               for shape in ((b, h * hd), (b, t, h, hd), (b, t, h, hd)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("t,pos", [(17, None), (145, None), (12, 0), (12, 5),
                                   (12, 11)])
def test_plain_op_is_attention_forward(t, pos, rows, dtype):
    """Cross-attention (all T live) and masked self-attention (positions
    <= pos of a T-slot cache): ``Attention.decode`` equals ``forward``
    with the reference's mask, bit for bit."""
    gen = torch.Generator().manual_seed(t * 100 + rows)
    attn = trocr.Attention(128, 4, dtype)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / 128 ** 0.5)
    xq = torch.randn((rows, 1, 128), generator=gen).to(dtype)
    _, k, v = _kv(rows, t, 4, 32, dtype, seed=t + rows)
    mask = None
    if pos is not None:
        pos = torch.tensor([pos])
        mask = torch.arange(t) <= pos
    with torch.inference_mode():
        want = attn(xq, None, mask=mask, kv_cache=(k, v))[0]
        got = attn.decode(xq, (k, v), pos)
    assert got.shape == want.shape == (rows, 1, 128)
    assert torch.equal(got, want)


def _old_decode(self, xq, kv, pos=None):
    """``Attention.decode`` as the steps computed it through ``forward``."""
    mask = None if pos is None else torch.arange(kv[0].shape[1]) <= pos
    return self(xq, None, mask=mask, kv_cache=kv)[0]


@pytest.mark.parametrize("kind", ["pre_norm_float32", "post_norm_bfloat16"])
def test_decode_loops_keep_todays_tokens(kind, monkeypatch):
    """The one decode loop (``greedy_generate``: ``greedy_step_`` over
    ``step_at``) through the op gives the tokens and confidences it gave
    through ``Attention.forward``."""
    kw = ({} if kind == "pre_norm_float32" else
          dict(post_norm_decoder=True, layernorm_embedding=True,
               pos_offset=2, dtype=torch.bfloat16))
    cfg = trocr.small_config(max_len=9, **kw)
    gen = torch.Generator().manual_seed(5)
    model = trocr.init_weights_(trocr.TrOCR(cfg), gen).eval()
    images = torch.rand((3, cfg.image_size, cfg.width, 3), generator=gen)
    new_t, new_c = trocr.greedy_generate(model, images * 2 - 1)
    monkeypatch.setattr(trocr.Attention, "decode", _old_decode)
    old_t, old_c = trocr.greedy_generate(model, images * 2 - 1)
    assert torch.equal(new_t, old_t) and torch.equal(new_c, old_c)


def test_cpu_calls_launch_nothing():
    q, k, v = _kv(2, 7, 2, 16, torch.float32, seed=1)
    before = op.decode_attention.launches
    op.decode_attention(q, k, v, torch.tensor([3]))
    assert op.decode_attention.launches == before
    assert op.launches_in_thread() == 0


def _bad_call(case):
    q, k, v = _kv(2, 7, 2, 16, torch.float32, seed=2)
    if case == "dtype":
        return (q.double(), k.double(), v.double(), None), TypeError
    if case == "mixed_dtype":
        return (q, k.bfloat16(), v, None), TypeError
    if case == "pos_dtype":
        return (q, k, v, torch.tensor([3], dtype=torch.int32)), TypeError
    if case == "inner_stride":
        kt = torch.randn(2, 7, 16, 2).transpose(2, 3)  # [B, T, H, hd] view
        return (q, kt, v, None), ValueError
    if case == "kv_shapes":
        return (q, k, v[:, :6], None), ValueError
    if case == "q_width":
        return (q[:, :16], k, v, None), ValueError
    if case == "empty_cache":
        return (q, k[:, :0], v[:, :0], None), ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "pos_dtype",
                                  "inner_stride", "kv_shapes", "q_width",
                                  "empty_cache"])
def test_wrapper_checks_raise(case):
    args, exc = _bad_call(case)
    with pytest.raises(exc):
        op.decode_attention(*args)


@pytest.mark.parametrize("hd,esize,want", [
    (64, 2, 128),  # trocr-base in bf16: 8 lanes a row, 32 rows a pass
    (32, 4, 128),  # the trained float32 TrOCR
    (16, 2, 512),  # 2 lanes a row
    (24, 2, 256),  # 3 loads, 4 lanes
    (128, 4, 32),  # 32 lanes: a warp a row
])
def test_pass_positions(hd, esize, want):
    assert op.pass_positions(hd, esize) == want


@pytest.mark.parametrize("rows,heads,t,want", [
    (16, 16, 577, 2),  # a full chunk's cross-attention: 512 blocks
    (5, 16, 577, 4),
    (1, 16, 577, 4),   # a one-crop tail: no more than a pass a block
    (16, 16, 50, 1),   # the self-attention cache: one block a head
    (1, 16, 50, 1),
    (16, 4, 145, 1),   # the trained float32 TrOCR
    (1, 16, 4096, 8),  # the most a cluster has
    (64, 16, 577, 1),
])
def test_cluster_size_fills_the_card(rows, heads, t, want):
    assert op.cluster_size(rows, heads, t, per_pass=128, sms=132) == want


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only there")
    return "cuda"


def _check_kernel(q, k, v, pos):
    """The kernel against the plain version on the card, within
    ``decode_attention.tolerance`` (its docstring gives the reason)."""
    b, t, h, hd = k.shape
    before = op.decode_attention.launches
    got = op.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert op.decode_attention.launches == before + 1
    want = op.decode_attention_plain(q, k, v, pos)
    assert got.dtype == want.dtype and got.shape == want.shape == (b, h * hd)
    err = (got.float() - want.float()).abs()
    tol = op.tolerance(q, k, v, pos, want)
    assert torch.isfinite(got).all()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16])
def test_kernel_cross_attention_bf16(card, rows):
    """trocr-base's cross-attention: the chunk's [rows, 577, 16, 64] bf16
    K/V, the first rows of a 16-row buffer as ``DecodeState.rows`` takes
    them."""
    q, k, v = _kv(16, 577, 16, 64, torch.bfloat16, seed=rows, device=card)
    _check_kernel(q[:rows], k[:rows], v[:rows], None)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 17, 49])
@pytest.mark.parametrize("view", ["masked", "slice"])
def test_kernel_self_attention_bf16(card, pos, view):
    """The 50-slot self-attention cache: masked at a device-held ``pos``
    (``step_at``) or sliced to ``pos + 1`` positions (a shorter T), 16
    rows."""
    q, k, v = _kv(16, 50, 16, 64, torch.bfloat16, seed=pos, device=card)
    if view == "masked":
        _check_kernel(q, k, v, torch.tensor([pos], device=card))
    else:
        _check_kernel(q, k[:, :pos + 1], v[:, :pos + 1], None)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16])
def test_kernel_slice_sums_as_the_mask(card, rows):
    """[:, :s+1] slices of the 50-slot cache give ``step_at``'s masked
    result at every step, bit for bit."""
    q, k, v = _kv(rows, 50, 16, 64, torch.bfloat16, seed=80 + rows,
                  device=card)
    for s in range(50):
        masked = op.decode_attention(q, k, v, torch.tensor([s], device=card))
        sliced = op.decode_attention(q, k[:, :s + 1], v[:, :s + 1])
        assert torch.equal(masked, sliced), s


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16])
def test_kernel_trained_float32(card, rows):
    """The repo's trained TrOCR: float32, 4 heads of 32, T = 6*24+1."""
    q, k, v = _kv(rows, 145, 4, 32, torch.float32, seed=40 + rows,
                  device=card)
    _check_kernel(q, k, v, None)
    _check_kernel(q, k[:, :16], v[:, :16], torch.tensor([9], device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 24, 128])
def test_kernel_float16_head_dims(card, hd):
    q, k, v = _kv(3, 577, 8, hd, torch.float16, seed=hd, device=card)
    _check_kernel(q, k, v, None)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _kv(2, 9, 2, 12, torch.bfloat16, seed=3, device=card)
    with pytest.raises(ValueError):
        op.decode_attention(q, k, v)  # hd 12: not a multiple of 8
