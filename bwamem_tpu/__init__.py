"""bwamem_tpu — a BWA-MEM short-read aligner in JAX for NVIDIA GPUs.

Built from scratch in JAX/XLA with the capabilities of the
peterpengwei/bwa-mem-sw hardware/software system (an FPGA banded
Smith-Waterman seed-extension accelerator for bwa-0.7.8): the full
BWA-MEM pipeline — FM-index SMEM seeding, seed chaining, banded
affine-gap seed extension, CIGAR generation, MAPQ and SAM emission —
re-designed for a batched accelerator.

Layer map (the accelerator analogue of SURVEY.md §1):

  io/        FASTA/FASTQ parsing, 2-bit reference encoding, SAM model
  index/     BWT / FM-index construction and device (HBM) layout
  ops/       compute kernels, each with a scalar numpy golden twin
             (*_ref.py) and a batched pure-JAX twin (*_jax.py);
             extend_step.py adds the CUDA extension kernel (csrc/cuda,
             through jax.ffi) for NVIDIA GPUs and picks the step per
             platform
  pipeline/  task packing (the TBB/RBB wire-format analogue), batching,
             the full read->alignment pipeline, CIGAR, MAPQ
  parallel/  jax.sharding Mesh / shard_map multi-device data parallelism
  utils/     timers, GCUPS accounting

The reference's 80 FPGA processing elements + batch_manager stream
machinery (see /root/reference/sw_pe_array.v, batch_manager.v) map to a
single banded-DP extension step batched over thousands of seeds per device,
fed by vectorized task packing.
"""

__version__ = "0.1.0"

from bwamem_tpu.config import MemOptions  # noqa: F401
