"""A batch of sequences a request through
``algorithms.fused.fused_decode_batch(..., pointers="auto")``, the function
``decode_batch(..., "fused")`` calls, on the resident tables.

Control: the same call at ``precision="bf16"``."""

from flash_viterbi_tpu_torch.algorithms import fused


def make(lh, control: bool = False):
    precision = "bf16" if control else "fp32"

    def call(ys):
        return fused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, ys, pointers="auto",
                                        precision=precision)

    return call
