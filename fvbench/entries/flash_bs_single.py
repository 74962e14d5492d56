"""One sequence a request through ``build("flash_bs", beam_width=B,
num_segments=N)``, called as ``Decoder.__call__(logA, logB, logPi, y)`` on
the resident tables, as ``decode(..., "flash_bs")`` runs it without its
upload and warm-up.  B and N are the cell's ``decoder``'s.

Control: the same entry at half the beam (``beam_width=B // 2``), a weaker
decode the check must fail."""

from flash_viterbi_tpu_torch import build


def make(lh, control: bool = False, decoder: dict | None = None):
    B, N = int(decoder["beam_width"]), int(decoder["num_segments"])
    dec = build("flash_bs", beam_width=B // 2 if control else B, num_segments=N)

    def call(ys):
        return dec(lh.logA, lh.logB, lh.logPi, ys[0])[None]

    return call
