"""Model-parallel topology state (``apex_tpu/transformer/
parallel_state.py``).

One installed :class:`~apex_tpu_torch.parallel.mesh.Mesh` over the
world's ranks with axes ``('pp', 'dp', 'sp', 'ep', 'tp')``; the getters
read its shape (world sizes) and this rank's coordinates (ranks).  The
JAX package's rank getters return traced ``axis_index`` values inside a
mapped computation; a torch process is one rank, so they are ints here.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import Mesh, create_mesh

__all__ = [
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "destroy_model_parallel",
    "install_mesh",
    "get_mesh",
    "get_tensor_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_data_parallel_world_size",
    "get_context_parallel_world_size",
    "get_tensor_model_parallel_rank",
    "get_pipeline_model_parallel_rank",
    "get_data_parallel_rank",
    "get_context_parallel_rank",
    "get_tensor_model_parallel_group",
    "get_data_parallel_group",
    "get_context_parallel_group",
    "get_virtual_pipeline_model_parallel_rank",
    "set_virtual_pipeline_model_parallel_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "is_pipeline_first_stage",
    "is_pipeline_last_stage",
    "get_pipeline_model_parallel_split_rank",
    "get_rank_info",
    "world_rank",
    "world_size",
    "TP_AXIS",
    "PP_AXIS",
    "DP_AXIS",
    "SP_AXIS",
]

TP_AXIS = "tp"
PP_AXIS = "pp"
DP_AXIS = "dp"
SP_AXIS = "sp"


class _State:
    mesh: Optional[Mesh] = None
    virtual_pipeline_model_parallel_size: Optional[int] = None
    virtual_pipeline_model_parallel_rank: Optional[int] = None
    pipeline_model_parallel_split_rank: Optional[int] = None


_STATE = _State()


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    context_parallel_size: int = 1,
    *,
    ranks=None,
) -> Mesh:
    """Build and install the mesh (reference parallel_state.py:81);
    ``context_parallel_size`` is the 'sp' axis."""
    mesh = create_mesh(tp=tensor_model_parallel_size_,
                       pp=pipeline_model_parallel_size_,
                       sp=context_parallel_size, ranks=ranks)
    install_mesh(mesh)
    _STATE.virtual_pipeline_model_parallel_size = (
        virtual_pipeline_model_parallel_size_)
    _STATE.virtual_pipeline_model_parallel_rank = (
        0 if virtual_pipeline_model_parallel_size_ is not None else None)
    _STATE.pipeline_model_parallel_split_rank = (
        pipeline_model_parallel_split_rank_)
    return mesh


def install_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the one the getters read (the step builders install
    theirs)."""
    _STATE.mesh = mesh


def model_parallel_is_initialized() -> bool:
    return _STATE.mesh is not None


def destroy_model_parallel() -> None:
    """reference parallel_state.py:646."""
    _STATE.mesh = None
    _STATE.virtual_pipeline_model_parallel_size = None
    _STATE.virtual_pipeline_model_parallel_rank = None
    _STATE.pipeline_model_parallel_split_rank = None


def get_mesh() -> Mesh:
    if _STATE.mesh is None:
        raise RuntimeError(
            "model parallel is not initialized; call "
            "initialize_model_parallel() first")
    return _STATE.mesh


def get_tensor_model_parallel_world_size() -> int:
    return get_mesh().shape[TP_AXIS]


def get_pipeline_model_parallel_world_size() -> int:
    return get_mesh().shape[PP_AXIS]


def get_data_parallel_world_size() -> int:
    return get_mesh().shape[DP_AXIS]


def get_context_parallel_world_size() -> int:
    return get_mesh().shape[SP_AXIS]


def get_tensor_model_parallel_rank() -> int:
    return get_mesh().coords[TP_AXIS]


def get_pipeline_model_parallel_rank() -> int:
    return get_mesh().coords[PP_AXIS]


def get_data_parallel_rank() -> int:
    return get_mesh().coords[DP_AXIS]


def get_context_parallel_rank() -> int:
    return get_mesh().coords[SP_AXIS]


def get_tensor_model_parallel_group():
    return get_mesh().group(TP_AXIS)


def get_data_parallel_group():
    return get_mesh().group(DP_AXIS)


def get_context_parallel_group():
    return get_mesh().group(SP_AXIS)


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _STATE.virtual_pipeline_model_parallel_rank


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    _STATE.virtual_pipeline_model_parallel_rank = rank


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _STATE.virtual_pipeline_model_parallel_size


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _STATE.pipeline_model_parallel_split_rank


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """reference parallel_state.py:560."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    if not ignore_virtual and _STATE.virtual_pipeline_model_parallel_size:
        if _STATE.virtual_pipeline_model_parallel_rank != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    vp = _STATE.virtual_pipeline_model_parallel_size
    if not ignore_virtual and vp:
        if _STATE.virtual_pipeline_model_parallel_rank != vp - 1:
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


def get_rank_info() -> str:
    """Compact topology string for log formatting
    (reference parallel_state.py:313)."""
    if not model_parallel_is_initialized():
        return ""
    m = get_mesh()
    return (f"[mesh pp={m.shape['pp']} dp={m.shape['dp']} "
            f"sp={m.shape['sp']} tp={m.shape['tp']}]")


def world_rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def world_size() -> int:
    """The world's size (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
