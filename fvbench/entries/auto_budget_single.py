"""One sequence a request through ``build("auto",
memory_budget_bytes=BUDGET_BYTES)``, called as ``Decoder.__call__(logA,
logB, logPi, y)`` on the resident tables: the decoder ``auto.choose``
picks for the shape within the budget, as ``decode(..., "auto",
memory_budget_bytes=BUDGET_BYTES)`` runs it, without its upload and
warm-up.  The budget is this module's constant, as the configuration
``config5_k16384_budget32m`` states it: neither a traffic mix's keys nor
the configuration reach an entry.

No control of its own: the decoder the budget picks at config-5's shape,
``checkpoint``, has no lower precision, so the harness puts the reference
at a bfloat16 table in its place."""

from flash_viterbi_tpu_torch import build

#: the device bytes a decode may allocate above the tables: 32 MiB
BUDGET_BYTES = 33_554_432


def make(lh, control: bool = False):
    if control:
        return None
    dec = build("auto", memory_budget_bytes=BUDGET_BYTES)

    def call(ys):
        return dec(lh.logA, lh.logB, lh.logPi, ys[0])[None]

    return call
