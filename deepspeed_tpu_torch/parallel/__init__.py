"""Parallel layers of the port: the device mesh over the ranks
(:mod:`deepspeed_tpu_torch.parallel.mesh`), the MoE layers for serving
and training (:mod:`deepspeed_tpu_torch.parallel.moe`), and sequence
parallelism: Ulysses (:mod:`~deepspeed_tpu_torch.parallel.ulysses`), ring
attention (:mod:`~deepspeed_tpu_torch.parallel.ring`) and FPDT
(:mod:`~deepspeed_tpu_torch.parallel.fpdt`)."""

from deepspeed_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES, ZERO_AXES, Mesh, build_mesh, get_data_parallel_world_size,
    get_expert_parallel_world_size, get_mesh,
    get_model_parallel_world_size, get_pipe_parallel_world_size,
    get_sequence_parallel_world_size, has_mesh, mesh_from_config,
    set_mesh)
