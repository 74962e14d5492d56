"""One sequence a request through ``build("auto")``, called as
``Decoder.__call__(logA, logB, logPi, y)`` on the resident tables: the
decoder ``auto.choose`` picks for the shape, as ``decode(..., "auto")``
runs it, without its upload and warm-up.

Control: the same entry at ``precision="bf16"`` (the port's own path that
rounds ``logA`` to bfloat16)."""

from flash_viterbi_tpu_torch import build


def make(lh, control: bool = False):
    dec = build("auto", precision="bf16") if control else build("auto")

    def call(ys):
        return dec(lh.logA, lh.logB, lh.logPi, ys[0])[None]

    return call
