"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bfloat16": 989e12,    # tensor cores, bf16 in, fp32 accumulate
    "tf32": 495e12,        # tensor cores, the highest fp32-input rate
    "float32": 67e12,      # outside the tensor cores
}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def mfu_peak(compute_dtype: str) -> float:
    """The peak a whole step's model operations are held against: bf16 for
    a bf16 configuration; for fp32 the TF32 rate, the chip's highest for
    fp32 inputs, so that no fp32-exact method reads above it."""
    return OPS_PER_S["bfloat16" if compute_dtype == "bfloat16" else "tf32"]
