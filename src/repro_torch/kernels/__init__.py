"""Hand-written Hopper kernels of the port, with their plain versions.

  layered_matmul    the paper's mini-job grid as one fused int8 pass
                    (CUDA C++, csrc/layered_matmul.cu; replaces the TPU
                    kernel in repro/kernels/layered_matmul.py)
ops.py holds the public wrappers, ref.py the NumPy oracles, _build.py the
nvcc build step.  The TPU's flash_attention and ssd_scan kernels are not
ported yet.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
