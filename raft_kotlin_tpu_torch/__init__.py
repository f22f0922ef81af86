"""raft_kotlin_tpu_torch — the PyTorch/CUDA port of raft_kotlin_tpu.

The same many-group Raft simulation (SEMANTICS.md is the shared spec), with
the same counted-threefry draws, so a run here is bit-equal to the JAX
package's run of the same config. The ticks run on an NVIDIA card through
hand-written CUDA kernels (ops/csrc/: one tick per launch, or T ticks per
launch with the draws made in the kernel); their plain PyTorch versions
run on the CPU. The port imports nothing of the JAX package.

Layout:
  models/  batched state schema (RaftState, init_state, numpy bridge)
  ops/     the phase lattice, the draws, the CUDA kernels + their build,
           the runners (make_run: one tick per launch; make_cuda_scan:
           fused launches over a flat carry)
  utils/   config, counted threefry, the flight recorder, the safety
           monitor
"""

from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops.cuda_scan import make_cuda_scan
from raft_kotlin_tpu_torch.ops.tick import make_run
from raft_kotlin_tpu_torch.utils.config import RaftConfig

__all__ = ["RaftConfig", "init_state", "make_cuda_scan", "make_run"]
