"""raft_kotlin_tpu_torch — the PyTorch/CUDA port of raft_kotlin_tpu.

The same many-group Raft simulation (SEMANTICS.md is the shared spec), with
the same counted-threefry draws, so a run here is bit-equal to the JAX
package's run of the same config. The tick runs on an NVIDIA card through a
hand-written CUDA kernel (ops/csrc/tick_kernel.cu); the plain PyTorch
version of that kernel (ops/tick.phase_body) runs on the CPU. The port
imports nothing of the JAX package.

Layout:
  models/  batched state schema (RaftState, init_state, numpy bridge)
  ops/     the phase lattice, the staged draws, the CUDA kernel + its build
  utils/   config, counted threefry, the flight recorder
"""

from raft_kotlin_tpu_torch.models.state import init_state
from raft_kotlin_tpu_torch.ops.tick import make_run
from raft_kotlin_tpu_torch.utils.config import RaftConfig

__all__ = ["RaftConfig", "init_state", "make_run"]
