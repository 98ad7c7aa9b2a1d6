"""The chunked path's carve and remesh on the card: no host read, and the
same result as on the CPU.

Needs an NVIDIA GPU (the step's labels go to a CUDA kernel with no CPU
mode), so these tests skip elsewhere; they import no JAX, so they run on
the GPU host: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_chunked_cuda.py``. On the filled 64³ bench scene after
one step, ``apply_absorption_chunk_gated`` and ``remesh_chunks`` run under
``torch.cuda.set_sync_debug_mode("error")`` (any host read raises) and are
held to the same calls on CPU copies of their inputs. The carve's i8 codes
may differ where the card's float32 norm rounds another way at a code
boundary: ±1 on at most 1e-4 of the voxels; its changed objects, dirty
chunks and deferred count equal. The remesh (of the card's carved pool on
both sides): integer outputs equal; triangle positions, normals and
materials within 1e-5 on the active triangles (unused slots hold whatever
the compaction's padding gathered)."""

import pytest
import torch

from impact_tpu_torch.models.bench import bench_chunked_config, bench_chunked_fill_scene
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.voxel.chunk_mesh import ChunkMeshPool, mark_objects_dirty, remesh_chunks
from impact_tpu_torch.voxel.interaction import AbsorberPools, apply_absorption_chunk_gated
from impact_tpu_torch.voxel.object import VoxelObjectPool

FLIP_SHARE = 1e-4
FLOAT_FIELDS = ("tri_pos", "tri_normal", "tri_albedo", "tri_f0", "tri_rough", "tri_emissive")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step's labels kernel has no CPU mode")
    return torch.device("cuda")


def _cpu(t):
    return type(t)(*(x.cpu() for x in t))


@pytest.mark.cuda
def test_carve_and_remesh_read_nothing_and_match_cpu(cuda_device):
    cfg = bench_chunked_config(64)
    rt = HeadlessRuntime(compile_scene(bench_chunked_fill_scene(64), cfg, device=cuda_device),
                         cfg, enable_fracturing=False)
    rt.step(1)
    s, p = rt.sim, rt.params
    b = s.phys.bodies
    budget = cfg.tpu.absorption_chunk_budget
    meshes = mark_objects_dirty(s.meshes, s.voxels.alive)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pool, changed, chunks, deferred = apply_absorption_chunk_gated(
            s.voxels, p.absorbers, b.position, b.orientation, budget, rotation=7 * budget)
        cp = remesh_chunks(meshes, pool, p.material_table, 16, cfg.tpu.chunk_vert_cap,
                           merge_levels=cfg.tpu.mesh_merge_levels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pool_c, changed_c, chunks_c, deferred_c = apply_absorption_chunk_gated(
        _cpu(s.voxels), _cpu(p.absorbers), b.position.cpu(), b.orientation.cpu(), budget,
        rotation=7 * budget)
    cp_c = remesh_chunks(_cpu(meshes), _cpu(pool), p.material_table.cpu(), 16,
                         cfg.tpu.chunk_vert_cap, merge_levels=cfg.tpu.mesh_merge_levels)
    assert isinstance(pool, VoxelObjectPool) and isinstance(p.absorbers, AbsorberPools)
    diff = pool.sdf.cpu().to(torch.int32) - pool_c.sdf.to(torch.int32)
    assert int((diff != 0).sum()) <= FLIP_SHARE * diff.numel() and int(diff.abs().max()) <= 1
    assert torch.equal(changed.cpu(), changed_c) and torch.equal(chunks.cpu(), chunks_c)
    assert int(deferred) == int(deferred_c) > 0
    assert isinstance(cp, ChunkMeshPool)
    act = cp_c.tri_active
    for f in ChunkMeshPool._fields:
        got, want = getattr(cp, f).cpu(), getattr(cp_c, f)
        if f in FLOAT_FIELDS:
            torch.testing.assert_close(got[act], want[act], atol=1e-5, rtol=0, msg=f)
        else:
            assert torch.equal(got, want), f
    assert int(cp.active.sum()) > 0
