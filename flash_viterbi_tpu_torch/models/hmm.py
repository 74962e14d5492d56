"""Dense HMM container, log-domain tables, and padding (PyTorch port).

Counterpart of ``flash_viterbi_tpu/models/hmm.py``.  ``HMM`` and ``_log32``
are numpy and produce the same bytes as the JAX package; ``LogHMM`` is an
``nn.Module`` whose tables are registered buffers, so ``.to(device)`` moves
them to the card in one call.

Tables are built on the card unless the caller asks for the CPU.

Padding contract: padded states are dead — their ``log Pi`` entries,
``log A`` rows and columns and ``log B`` rows are ``-inf``, so they never
win an argmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


def _log32(p: np.ndarray) -> np.ndarray:
    """float64 log truncated to float32; log(0) -> -inf, matching C log().

    NaN probabilities (the generator's 0/0 rows for states without edges)
    map to -inf, an absent edge: a max would otherwise propagate NaN into
    every later score, where the reference's strict '>' compare skips it."""
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log(np.asarray(p, dtype=np.float64)).astype(np.float32)
    out[np.isnan(out)] = np.float32("-inf")
    return out


def resolve_device(device) -> torch.device:
    """The device to place tables or decode on; raises if CUDA is asked
    for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HMM:
    """Dense HMM in probability space (host side, numpy)."""

    A: np.ndarray  # (K, K) transition probabilities, rows sum to 1
    B: np.ndarray  # (K, M) emission probabilities, rows sum to 1
    Pi: np.ndarray  # (K,) initial probabilities

    @property
    def K(self) -> int:
        return int(self.A.shape[0])

    @property
    def M(self) -> int:
        return int(self.B.shape[1])

    def __post_init__(self):
        if not (self.A.ndim == 2 and self.A.shape[0] == self.A.shape[1]):
            raise ValueError(f"A must be square, got {self.A.shape}")
        if not (self.B.ndim == 2 and self.B.shape[0] == self.A.shape[0]):
            raise ValueError(f"B must be (K, M), got {self.B.shape}")
        if not (self.Pi.ndim == 1 and self.Pi.shape[0] == self.A.shape[0]):
            raise ValueError(f"Pi must be (K,), got {self.Pi.shape}")

    def log(self, device="cuda") -> "LogHMM":
        """The fp32 log tables on ``device``."""
        return LogHMM.from_numpy(_log32(self.A), _log32(self.B),
                                 _log32(self.Pi), K=self.K, device=device)


class LogHMM(nn.Module):
    """Log-domain HMM, optionally padded to ``Kp >= K`` states.

    Buffers: ``logA (Kp, Kp)``, ``logB (Kp, M)``, ``logPi (Kp,)``, all
    float32.  ``K`` is the logical state count.
    """

    logA: torch.Tensor
    logB: torch.Tensor
    logPi: torch.Tensor

    def __init__(self, logA: torch.Tensor, logB: torch.Tensor,
                 logPi: torch.Tensor, K: int):
        super().__init__()
        Kp = logA.shape[0]
        if logA.shape != (Kp, Kp) or logB.shape[0] != Kp or logPi.shape != (Kp,):
            raise ValueError(f"inconsistent table shapes {tuple(logA.shape)}, "
                             f"{tuple(logB.shape)}, {tuple(logPi.shape)}")
        for name, t in (("logA", logA), ("logB", logB), ("logPi", logPi)):
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
            self.register_buffer(name, t)
        self.K = int(K)

    @classmethod
    def from_numpy(cls, logA, logB, logPi, K: int, device="cuda") -> "LogHMM":
        """Tables from numpy float32 arrays (for example the JAX package's
        ``LogHMM`` fields), byte for byte, on ``device``."""
        dev = resolve_device(device)

        def put(x):
            arr = np.ascontiguousarray(x)
            if arr.dtype != np.float32:
                raise ValueError(f"expected float32 tables, got {arr.dtype}")
            return torch.from_numpy(arr.copy()).to(dev)

        return cls(put(logA), put(logB), put(logPi), K)

    @property
    def Kp(self) -> int:
        return int(self.logA.shape[0])

    @property
    def M(self) -> int:
        return int(self.logB.shape[1])

    def padded(self, multiple: int = 128) -> "LogHMM":
        """Pad the state dimension to ``multiple``; padded states are dead."""
        Kp = round_up(self.Kp, multiple)
        if Kp == self.Kp:
            return self
        k0 = self.Kp
        neg = float("-inf")
        dev = self.logA.device
        logA = torch.full((Kp, Kp), neg, dtype=torch.float32, device=dev)
        logA[:k0, :k0] = self.logA
        logB = torch.full((Kp, self.M), neg, dtype=torch.float32, device=dev)
        logB[:k0] = self.logB
        logPi = torch.full((Kp,), neg, dtype=torch.float32, device=dev)
        logPi[:k0] = self.logPi
        return LogHMM(logA, logB, logPi, K=self.K)
