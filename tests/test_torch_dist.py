"""The port's process-group helpers (``prometheus_torch/parallel/dist.py``)
against ``prometheus_tpu/parallel/mesh.py``: the FSDP split rule and the
per-host batch on the same shapes, the batch and view slicing, a 2 x 2
hybrid mesh's layout, and the autograd gather of the view-sharded
attention, over ``gloo`` in 4 CPU processes (mirrors
``tests/test_parallel.py``). Exact: integer layouts and copies; the
gather's gradient is a sum of 4 float32 terms (``atol 1e-6``).
"""
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from prometheus_tpu.parallel import mesh as jax_mesh
from prometheus_torch.parallel import dist
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
import torch_dist_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")

SHAPES = [(320, 4, 3, 3), (1024, 1024), (4, 1024), (77, 1024), (49408, 64),
          (7, 7, 3, 1000), (2048,), (255, 257), (1152, 6912)]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_fsdp_param_spec_matches_jax(world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    for shape in SHAPES:
        spec = jax_mesh.fsdp_param_spec(jax.ShapeDtypeStruct(shape,
                                                             np.float32),
                                        mesh).spec
        want = next((d for d, a in enumerate(spec) if a == "data"), None)
        assert dist.fsdp_param_spec(shape, world) == want, shape


def test_local_batch_size_and_slicing():
    """One process is one host of the JAX package: the whole batch; the
    slicing helpers at world size 1 return their input."""
    assert jax.process_count() == 1
    for b in (1, 8, 24):
        assert dist.local_batch_size(b) == jax_mesh.local_batch_size(b) == b
    batch = {"images_mv": torch.arange(24.0).reshape(2, 4, 3),
             "text_emb": torch.ones(2, 5)}
    for sliced in (dist.shard_batch(batch), dist.shard_batch_views(batch)):
        assert all(torch.equal(v, batch[k]) for k, v in sliced.items())
    assert dist.is_main_process()


@pytest.fixture(scope="module")
def four():
    return dist.spawn_local(ranks.dist_ranks, 4)


def test_hybrid_mesh_layout(four):
    """A 2 x 2 ``("dcn", "data")`` mesh: node s holds ranks 2s, 2s + 1;
    FSDP's group is the rank's node, the batch's the world."""
    for rank, out in enumerate(four):
        assert out["hybrid_shape"] == (2, 2)
        assert out["hybrid_names"] == ("dcn", "data")
        assert out["data_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert out["dcn_ranks"] == [rank % 2, rank % 2 + 2]
        assert out["flat_ranks"] == [0, 1, 2, 3]
        assert out["local_batch"] == 2


def test_shard_batch_and_views_over_ranks(four):
    """Rank r keeps rows ``[r n, (r + 1) n)`` of each of the 2 micro-
    batches, and views ``[r, r + 1)`` of the ``*_mv`` leaves only."""
    x = torch.arange(16.0).reshape(16, 1)
    for rank, out in enumerate(four):
        rows = x.reshape(2, 4, 2, 1)[:, rank].reshape(4, 1)
        assert torch.equal(out["rows"], rows)
        assert torch.equal(out["views"]["images_mv"],
                           torch.arange(8.0).reshape(2, 4)[:, rank:rank + 1])
        assert out["views"]["text_emb"].shape == (2, 3)
        assert out["fsdp_shapes"] == {"big": (256, 64), "small": (4, 4)}


def test_gather_tokens_forward_and_backward(four):
    """The gather concatenates in rank order; the gradient that reaches a
    rank's input is the sum over the ranks of their gradients of its
    slice (JAX's transpose of ``all_gather``)."""
    parts = [torch.full((1, 2, 3), float(r)) for r in range(4)]
    full = torch.cat(parts, dim=1)
    for rank, out in enumerate(four):
        assert torch.equal(out["gathered"], full)
        # rank s weights the gathered tensor by (s + 1): the gradient of
        # rank r's slice is sum_s (s + 1) = 10
        torch.testing.assert_close(out["grad"], torch.full((1, 2, 3), 10.0),
                                   atol=1e-6, rtol=0)
        assert out["reduced"] == [6.0, 12.0]
