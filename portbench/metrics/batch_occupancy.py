"""Engine (``runtime/engine.py``): valid frames submitted over the window
divided by the slots of the batches it dispatched there
(``InferenceEngine.batches_dispatched`` times the batch size), in %.
Moves ``clip_latency_p95_ms``."""

UNIT = "%"


def read(ctx):
    batches = ctx.get("engine_batches")
    if not batches:
        return None
    size = ctx["config"]["pipeline"]["batch_size"]
    return 100.0 * ctx["counts"]["valid_frames"] / (batches * size)
