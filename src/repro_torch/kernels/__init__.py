"""Hand-written Hopper kernels of the port, with their plain versions.

  layered_matmul    the paper's mini-job grid as one fused int8 pass
                    (CUDA C++, two kernels routed by the plane count:
                    csrc/layered_matmul_wgmma.cu, m <= 3 on int8 wgmma
                    with TMA; csrc/layered_matmul.cu, m = 4 on int8
                    mma.sync; replaces the TPU kernel in
                    repro/kernels/layered_matmul.py)
  flash_attention   online-softmax attention, causal skip, window, GQA
                    (CUDA C++, three kernels routed by dtype and head dim:
                    csrc/flash_attention_wgmma.cu, bf16 dh 64/128, and
                    csrc/flash_attention_wgmma_d256.cu, bf16 dh 256, on
                    the tensor cores; csrc/flash_attention.cu, fp32 and
                    the other head dims on the CUDA cores; replaces
                    repro/kernels/flash_attention.py)
  ssd_scan          the fused Mamba2 SSD chunk scan with carried state
                    (CUDA C++, two kernels routed by dtype and shape:
                    csrc/ssd_scan_wgmma.cu, bf16 x/B/C with P 64, N 128
                    and chunks of 64..256 on the tensor cores;
                    csrc/ssd_scan.cu, fp32 and the other shapes on the
                    CUDA cores; replaces repro/kernels/ssd_scan.py), and
                    its backward for the tensor-core kernel's inputs
                    (csrc/ssd_scan_bwd.cu on mma.sync; replaces no TPU
                    kernel)
ops.py holds the public wrappers, ref.py the NumPy oracles, _build.py the
nvcc build step.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
