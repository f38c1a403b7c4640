"""Published peaks of the cards the benchmark runs on, and the roofline
arithmetic that the per-layer metrics share.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
power limit of 700 W: 3.35 TB/s of HBM3, 989 TFLOP/s bf16 on the tensor
cores, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor cores.
A card set below 700 W runs slower under load: each run prints the limit
beside its numbers.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12},
}


def peak(kind: str):
    """The card's row of PEAKS, or None for a card not in the table."""
    return PEAKS.get(kind)


def bound_s(nbytes: float, flops: float, flops_per_s: float,
            bytes_per_s: float) -> float:
    """Least time of a launch: its bytes over the memory's rate or its
    operations over the compute peak, whichever is longer."""
    return max(nbytes / bytes_per_s, flops / flops_per_s)


# frozen copy of mask3d_tpu_torch/profile_forward.py GROUPS: (group,
# substrings of the kernel name), first match wins
GROUPS = (
    ("masked_attention kernel", ("mca_partial", "mca_combine")),
    ("row_gather kernel", ("row_gather_kernel",)),
    ("sparse_conv kernel", ("sparse_conv_kernel",)),
    ("int8_conv kernel", ("int8_conv_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "wgrad",
                              "dgrad", "fprop")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("index/scatter/cat", ("index", "scatter", "gather", "cat", "copy")),
)


def group(kernel_name: str) -> str:
    low = kernel_name.lower()
    for name, keys in GROUPS:
        if any(k in low for k in keys):
            return name
    return "other"
