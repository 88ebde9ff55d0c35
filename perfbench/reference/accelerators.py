"""Accelerator communication profiles and the configurable traffic-generator.

Paper §5: "From the viewpoint of the rest of the SoC, an accelerator can be
characterized by its patterns of communication with the memory hierarchy."
The traffic-generator parameters are exactly the paper's list: access
pattern (streaming / strided / irregular), DMA burst length, compute
duration, data reuse factor, read-to-write ratio, stride length, access
fraction, and in-place storage.

The 12 named profiles model the ESP accelerators of Table 2 at the same
granularity the traffic-generator uses — what matters to the memory system
is the pattern, not the math inside the datapath.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

STREAMING, STRIDED, IRREGULAR = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class AccProfile:
    """Traffic-generator parameter bundle for one accelerator (paper §5)."""

    name: str
    pattern: int = STREAMING
    burst_bytes: float = 256.0    # DMA burst length
    compute_per_byte: float = 2.0  # datapath cycles per byte processed
    reuse: float = 1.0            # times each input byte is re-read
    read_frac: float = 0.75       # read / (read + write) traffic split
    stride_bytes: float = 0.0     # strided pattern stride
    access_frac: float = 1.0      # irregular: fraction of footprint touched
    in_place: bool = False        # output overwrites input region
    engines: int = 1              # internal engines (night-vision has 4)

    def asarray(self) -> np.ndarray:
        """Pack into a flat float32 vector for the timing model."""
        return np.asarray(
            [
                self.pattern,
                self.burst_bytes,
                self.compute_per_byte,
                self.reuse,
                self.read_frac,
                self.stride_bytes,
                self.access_frac,
                1.0 if self.in_place else 0.0,
                self.engines,
            ],
            np.float32,
        )


class ProfileArray(NamedTuple):
    """Column names for the packed profile vector."""

    PATTERN: int = 0
    BURST: int = 1
    COMPUTE: int = 2
    REUSE: int = 3
    READ_FRAC: int = 4
    STRIDE: int = 5
    ACCESS_FRAC: int = 6
    IN_PLACE: int = 7
    ENGINES: int = 8


PF = ProfileArray()
PROFILE_WIDTH = 9

# The ESP accelerator suite (paper Table 2 / §3).  Parameters chosen to
# reproduce the communication behaviour reported in the paper: GEMM / MRI-Q
# are compute-bound with heavy reuse, SPMV is irregular and latency-bound,
# FFT is a multi-pass in-place strided kernel, Sort is a multi-pass
# streaming kernel, etc.
PROFILES = {
    "autoencoder": AccProfile("autoencoder", STREAMING, 512, 0.2, 2.0, 0.80),
    "cholesky": AccProfile("cholesky", STRIDED, 128, 0.8, 3.0, 0.70,
                           stride_bytes=512, in_place=True),
    "conv2d": AccProfile("conv2d", STREAMING, 256, 0.5, 2.0, 0.80),
    "fft": AccProfile("fft", STRIDED, 64, 0.25, 3.0, 0.50,
                      stride_bytes=1024, in_place=True),
    "gemm": AccProfile("gemm", STREAMING, 512, 2.5, 4.0, 0.85),
    "mlp": AccProfile("mlp", STREAMING, 512, 0.5, 1.5, 0.85),
    "mriq": AccProfile("mriq", STREAMING, 256, 5.0, 1.0, 0.90),
    "nvdla": AccProfile("nvdla", STREAMING, 256, 1.2, 3.0, 0.80),
    "nightvision": AccProfile("nightvision", STREAMING, 128, 1.2, 2.0, 0.60,
                              engines=4),
    "sort": AccProfile("sort", STREAMING, 256, 0.15, 4.0, 0.50, in_place=True),
    "spmv": AccProfile("spmv", IRREGULAR, 8, 0.2, 1.2, 0.90, access_frac=0.4),
    "viterbi": AccProfile("viterbi", STRIDED, 64, 0.8, 2.0, 0.75,
                          stride_bytes=256),
}


def sample_traffic_profile(rng: np.random.Generator, name: str) -> AccProfile:
    """Sample a random traffic-generator configuration (paper §5).

    Used for SoC1/2/3 whose accelerators are traffic-generator instances.
    """
    pattern = int(rng.integers(0, 3))
    return AccProfile(
        name=name,
        pattern=pattern,
        burst_bytes=float(rng.choice([8, 16, 64, 128, 256, 512, 1024])),
        compute_per_byte=float(rng.uniform(0.1, 5.0)),
        reuse=float(rng.uniform(1.0, 4.0)),
        read_frac=float(rng.uniform(0.4, 0.95)),
        stride_bytes=float(rng.choice([64, 256, 1024])) if pattern == STRIDED else 0.0,
        access_frac=float(rng.uniform(0.1, 0.6)) if pattern == IRREGULAR else 1.0,
        in_place=bool(rng.uniform() < 0.3),
    )


def sample_streaming_profile(rng: np.random.Generator, name: str) -> AccProfile:
    """Streaming-only traffic-gen set (Fig. 9 'SoC0 streaming')."""
    return dataclasses.replace(
        sample_traffic_profile(rng, name),
        pattern=STREAMING, stride_bytes=0.0, access_frac=1.0,
        burst_bytes=float(rng.choice([256, 512, 1024])),
    )


def sample_irregular_profile(rng: np.random.Generator, name: str) -> AccProfile:
    """Irregular-only traffic-gen set (Fig. 9 'SoC0 irregular')."""
    return dataclasses.replace(
        sample_traffic_profile(rng, name),
        pattern=IRREGULAR, burst_bytes=float(rng.choice([8, 16])),
        access_frac=float(rng.uniform(0.1, 0.6)),
        reuse=float(rng.uniform(1.2, 3.0)),
    )


def resolve_profiles(names, rng: np.random.Generator | None = None,
                     flavor: str = "mixed") -> list[AccProfile]:
    """Map SoC accelerator names to profiles; traffic* names are sampled."""
    rng = rng or np.random.default_rng(0)
    sampler = {
        "mixed": sample_traffic_profile,
        "streaming": sample_streaming_profile,
        "irregular": sample_irregular_profile,
    }[flavor]
    out = []
    for n in names:
        if n.startswith("traffic"):
            out.append(sampler(rng, n))
        else:
            out.append(PROFILES[n])
    return out


def profile_matrix(profiles) -> np.ndarray:
    """(n_accs, PROFILE_WIDTH) float32 matrix for the timing model."""
    return np.stack([p.asarray() for p in profiles]).astype(np.float32)
