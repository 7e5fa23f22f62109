"""L-PCN in PyTorch for NVIDIA Hopper: the port of ``repro`` (JAX/TPU).

Module names mirror the JAX package (``core``, ``engine``, ``kernels``,
``models``) so each counterpart is easy to find.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; the two FC
dataflows run in hand-written CUDA kernels (``kernels/``, sources in
``csrc/``), with a plain PyTorch version beside each.
"""

HW = dict(  # NVIDIA H100 SXM5 80 GB: the data sheet's peaks, not measured
    peak_bf16_flops=989e12,    # dense bf16 on the tensor cores, per card
    peak_tf32_flops=495e12,    # dense TF32 on the tensor cores
    peak_fp32_flops=67e12,     # fp32 on the CUDA cores
    hbm_bw=3.35e12,            # bytes/s of HBM3 per card
    nvlink_bw=450e9,           # bytes/s per card, one direction (NVLink 4)
    hbm_bytes=80e9,            # 80 GB of HBM3 per card
    smem_bytes=227 * 1024,     # the most shared memory a block opts into
    sms=132,                   # streaming multiprocessors (the tile plans'
                               # input where no card is asked)
)
