"""Device kernels per completed sequence in the profiled sub-window: every
kernel the session recorded (the port's and PyTorch's), over the sequences
completed in it.  Layer: glue (``algorithms/fused.py``,
``algorithms/longform.py``, entered through ``algorithms/base.py`` and
``algorithms/auto.py``)."""


def read(tr):
    if not tr.kernels or not tr.sequences:
        return None
    return len(tr.kernels) / tr.sequences
