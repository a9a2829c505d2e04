"""TrajDiT's trunk replayed as a CUDA graph (``models/traj_dit.py``,
``TrunkGraphs``) against the same modules run eagerly, on the card, at the
flagship widths in bf16 (hidden 512, 8 blocks, text width 1024).

The graph runs the same kernels on the same inputs, so every comparison is
bit-equal. This file imports no JAX: on the card's machine run it with
``python -m pytest tests/test_torch_traj_graph.py -m gpu --noconftest``.
Here every test skips.
"""
import copy

import pytest
import torch

from prometheus_torch import profiling
from prometheus_torch.models.traj_dit import GRAPHS_KEPT, TrajDiTModel
from prometheus_torch.systems import TrajDiTSystem

pytestmark = pytest.mark.gpu


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.manual_seed(0)
    with torch.device("cuda"):
        return TrajDiTModel().to(torch.bfloat16).eval()


def inputs(B, seed=1, L=77):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(B, 29, 11, device="cuda", generator=g)
    y = torch.randn(B, L, 1024, device="cuda", generator=g).to(torch.bfloat16)
    t = torch.randint(0, 1000, (B,), device="cuda", generator=g).float()
    return x, y, t


def eager(model, x, y, t):
    return model.out_block(model.trunk(x, y, t))


@pytest.mark.parametrize("B", [1, 4])
@torch.no_grad()
def test_graphed_forward_is_bit_equal_to_eager(model, B):
    for seed in (1, 2, 3):       # the capture's call, then two replays
        x, y, t = inputs(B, seed)
        assert model.eager_reason(x) is None
        assert torch.equal(model(x, y, t), eager(model, x, y, t))
    assert len(model.graphs.graphs) == 1


def test_sample_tokens_100_steps_same_tokens_both_ways(model):
    _, text, _ = inputs(4)
    noise = torch.randn(4, 29, 11, device="cuda")
    sys_ = TrajDiTSystem(model=model)
    graphed = sys_.sample_tokens(text, num_inference_steps=100, noise=noise)
    assert len(model.graphs.graphs) == 1
    # a hook on a trunk module keeps the trunk eager
    handle = model.block_0.register_forward_pre_hook(lambda *a: None)
    with torch.no_grad():
        assert model.eager_reason(noise) == "hook"
    eager_tokens = sys_.sample_tokens(text, num_inference_steps=100,
                                      noise=noise)
    handle.remove()
    assert torch.equal(graphed, eager_tokens)


@torch.no_grad()
def test_a_prediction_is_not_overwritten_by_the_next_call(model):
    first = model(*inputs(4, 1))
    kept = first.clone()
    second = model(*inputs(4, 2))
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


@torch.no_grad()
def test_out_block_pre_hook_sees_each_steps_hidden_state(model):
    seen = []
    handle = model.out_block.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].clone()))
    calls = [inputs(2, seed) for seed in (1, 2, 3)]
    for x, y, t in calls:
        assert model.eager_reason(x) is None
        model(x, y, t)
    handle.remove()
    assert len(seen) == 3
    for h, (x, y, t) in zip(seen, calls):
        assert torch.equal(h, model.trunk(x, y, t))


@torch.no_grad()
def test_new_storage_recaptures_and_in_place_writes_are_read(model):
    x, y, t = inputs(4)
    before = model(x, y, t)
    # written in place: the graph reads it live, no new capture
    model.in_block.weight.mul_(2)
    assert torch.equal(model(x, y, t), eager(model, x, y, t))
    assert len(model.graphs.graphs) == 1
    # load_state_dict into new storage
    state = {k: torch.randn_like(v) * 0.02 for k, v in
             model.state_dict().items()}
    model.load_state_dict(state, assign=True)
    after = model(x, y, t)
    assert torch.equal(after, eager(model, x, y, t))
    assert not torch.equal(after, before)
    # .to(dtype): new storage and a new key
    model.float()
    got = model(x, y, t)
    assert got.dtype == torch.float32
    assert torch.equal(got, eager(model, x, y, t))
    assert len(model.graphs.graphs) == 1


def test_inference_mode_then_no_grad(model):
    x, y, t = inputs(2)
    with torch.inference_mode():
        a = model(x, y, t)
    with torch.no_grad():
        b = model(x, y, t)
    assert torch.equal(a, b)
    assert len(model.graphs.graphs) == 1


@torch.no_grad()
def test_least_recently_used_graph_goes(model):
    for B in range(1, GRAPHS_KEPT + 2):
        model(*inputs(B))
    assert len(model.graphs.graphs) == GRAPHS_KEPT
    assert min(key[0][0][0] for key in model.graphs.graphs) == 2
    x, y, t = inputs(1, 5)
    assert torch.equal(model(x, y, t), eager(model, x, y, t))


@torch.no_grad()
def test_a_copy_starts_with_no_graphs(model):
    x, y, t = inputs(2)
    model(x, y, t)
    twin = copy.deepcopy(model)
    assert len(model.graphs.graphs) == 1 and not twin.graphs.graphs
    assert torch.equal(twin(x, y, t), eager(model, x, y, t))


@pytest.mark.parametrize("captured_in_trace", [False, True])
def test_traced_call_counts_each_step_replayed(model, tmp_path,
                                               captured_in_trace):
    _, text, _ = inputs(4)
    noise = torch.randn(4, 29, 11, device="cuda")
    sys_ = TrajDiTSystem(model=model)
    if not captured_in_trace:
        sys_.sample_tokens(text, num_inference_steps=2, noise=noise)
    with profiling.trace(str(tmp_path)):
        got = sys_.sample_tokens(text, num_inference_steps=10, noise=noise)
    assert profiling.counters()["graphs"] == {"traj": {
        "captured": int(captured_in_trace), "replayed": 10, "eager": 0}}
    handle = model.block_0.register_forward_pre_hook(lambda *a: None)
    want = sys_.sample_tokens(text, num_inference_steps=10, noise=noise)
    handle.remove()
    assert torch.equal(got, want)
