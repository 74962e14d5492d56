"""A batch of sequences a request through
``build("flash_long", num_segments=1).batch_fn``, the function
``decode_batch(..., "flash_long")`` calls (phases A and B of the batched
pipeline; one segment, so no phase 2), on the resident tables.

No control of its own: ``flash_long`` has no lower precision, so the
harness puts the reference at a bfloat16 table in its place."""

from flash_viterbi_tpu_torch import build


def make(lh, control: bool = False):
    if control:
        return None
    batch_fn = build("flash_long", num_segments=1).batch_fn

    def call(ys):
        return batch_fn(lh.logA, lh.logB, lh.logPi, ys)

    return call
