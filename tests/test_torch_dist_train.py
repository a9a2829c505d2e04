"""Training over ``torch.distributed`` (``gloo``, 2 and 4 CPU processes)
against one process: data parallelism with gradient accumulation, the
``--sp_views`` trainer (its views split over 2 ranks, the gradients
summed), FSDP
(``parallel.ZeroShards``) against replicated, on a flat and on a 2 x 2
hybrid mesh, checkpoints between 2 ranks and 1 process, and
``train.main`` under 2 ranks (mirrors ``tests/test_parallel.py``'s
data-parallel and FSDP checks for the port).

Two spawns: 4 ranks (``torch_dist_ranks.train_ranks``: pairs for the
2-rank runs, the world for the 4-rank ones) and 2 ranks
(``main_ranks``). The stage-2 trainer runs at ``--small`` widths on
synthetic batches.

Tolerances: ranks against one process ``1e-5`` absolute on the
parameters and the EMA after 2 steps, and ``rtol 1e-5`` on the losses and
on the gradient norms before the clip (only the order of the sums differs;
the norm is what sees a gradient's scale, which the clip and AdamW cancel);
``--sp_views``'s reduced gradients within ``1e-5`` of a tensor's largest
gradient (or of 1e-2 of the largest of all, where its own is of rounding
size, as in ``test_torch_view_sharded``); FSDP against replicated, and hybrid
against flat, bit-equal (the same reduced gradients, the same AdamW
arithmetic on slices); checkpoints bit-equal both ways.
"""
import json

import pytest
import torch

from prometheus_torch.checkpoint import restore_checkpoint, save_checkpoint
from prometheus_torch.parallel.dist import fsdp_param_spec, spawn_local
from prometheus_torch.train import SP_VIEW_SEED, main
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
import torch_dist_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")


def max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def bit_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


def sp_reference(world: int = 2, seed: int = 0) -> dict:
    """The ``--sp_views`` trainer's 2 steps over ``world`` ranks, in one
    process: the plain stage-2 trainer on the same batches, its loss taking
    the draws the ranks make (every rank draws the scene-level ones from
    the shared generator, and its own views' noise from its per-view
    generator), assembled into the whole scene's."""
    tr = ranks.mvldm_trainer(None, 2, 1, seed=seed)
    system, g, cfg = tr.system, tr.generator, tr.cfg
    view_gs = [torch.Generator().manual_seed(seed + SP_VIEW_SEED * (r + 1))
               for r in range(world)]
    drop = dict(drop_pose_p=cfg["drop_pose_p"],
                drop_text_p=cfg["drop_text_p"])

    def loss_fn(batch):
        B, N = batch["images_mv"].shape[:2]
        n = N // world
        hw = batch["images_mv"].shape[-1] // 2 ** (
            len(system.model.vae_ch_mult) - 1)
        state, parts = g.get_state(), []
        for vg in view_gs:
            g.set_state(state)
            parts.append(system.draw_multi_view(
                g, B, n, hw, view_generator=vg, num_global_views=N, **drop))
        enc = [p["encode_noise"] for p in parts]
        draws = dict(parts[0],
                     noise=torch.cat([p["noise"] for p in parts], 1),
                     encode_noise=torch.cat([e[:, :n] for e in enc]
                                            + [e[:, n:] for e in enc], 1))
        return system.multi_view_loss(batch, draws=draws, **drop)

    tr.loss_fn = loss_fn
    return ranks.run_steps(tr)


@pytest.fixture(scope="module")
def four():
    """The one-process runs (global batches of 4: 2 micro-batches of 2,
    and 1 of 4; the ``--sp_views`` reference) and the 4-rank spawn."""
    one_accum = ranks.run_steps(ranks.mvldm_trainer(None, 4, 2))
    one_flat = ranks.run_steps(ranks.mvldm_trainer(None, 4, 1))
    return (one_accum, one_flat, spawn_local(ranks.train_ranks, 4),
            sp_reference())


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """A one-process run's checkpoint after 1 step, ``train.main`` in one
    process (global batch 2), and the 2-rank spawn."""
    tmp = tmp_path_factory.mktemp("dist_train")
    one = ranks.mvldm_trainer(None, 2, 1)
    ranks.run_steps(one, 1)
    save_checkpoint(str(tmp / "in"), one.state, 1)
    ref = main(["--stage", "mvldm", "--synthetic", "--small", "--device",
                "cpu", "--max_steps", "2", "--batch_size", "2",
                "--log_every", "1", "--ckpt_dir", str(tmp / "main1")])
    outs = spawn_local(ranks.main_ranks, 2, args=(
        str(tmp / "in" / "step_000000001"), str(tmp / "out"),
        str(tmp / "main2")))
    return tmp, one, ref, outs


def test_data_parallel_with_accumulation_equals_one_process(four):
    """2 ranks x 2 micro-batches of 1 = one process's 2 micro-batches of
    2: each rank's micro-batch i is its slice of the global micro-batch
    i, and the losses' draws are the global batch's, sliced."""
    one, _, outs, _ = four
    for out in outs:
        dp = out["dp"]
        for key in ("losses", "grad_norms"):
            torch.testing.assert_close(torch.tensor(dp[key]),
                                       torch.tensor(one[key]), rtol=1e-5,
                                       atol=0)
        assert max_diff(dp["params"], one["params"]) <= 1e-5
        assert max_diff(dp["ema"], one["ema"]) <= 1e-5


def test_sp_views_trainer_on_two_ranks_equals_one_process(four):
    """``build_mvldm_trainer`` with ``--sp_views`` on 2 ranks (its own loss,
    batches and step: each rank's term backpropagated, the gradients
    summed) against one process on the draws the ranks made: the losses,
    the gradient norms before the clip, the reduced gradients of the last
    step and the parameters after 2 steps."""
    _, _, outs, one = four
    for out in outs:
        sp = out["sp"]
        for key in ("losses", "grad_norms"):
            torch.testing.assert_close(torch.tensor(sp[key]),
                                       torch.tensor(one[key]), rtol=1e-5,
                                       atol=0)
        assert set(sp["grads"]) == set(one["grads"])
        top = max(float(g.abs().max()) for g in one["grads"].values())
        for name, g in one["grads"].items():
            scale = max(float(g.abs().max()), 1e-2 * top)
            assert float((sp["grads"][name] - g).abs().max()) <= (
                1e-5 * scale), name
        assert max_diff(sp["params"], one["params"]) <= 1e-5


def test_fsdp_equals_replicated_with_the_rule_s_shard_sizes(four):
    _, _, outs, _ = four
    sharded = 0
    for out in outs:
        assert bit_equal(out["fsdp"]["params"], out["replicated"]["params"])
        assert bit_equal(out["fsdp"]["ema"], out["replicated"]["ema"])
        assert out["fsdp"]["losses"] == out["replicated"]["losses"]
        assert out["fsdp"]["grad_norms"] == out["replicated"]["grad_norms"]
        for name, numel in out["shard_numel"].items():
            full = out["fsdp"]["params"][name]
            dim = fsdp_param_spec(full.shape, 2, ranks.FSDP_MIN)
            assert numel == (full.numel() if dim is None
                             else full.numel() // 2), name
            sharded += dim is not None
    assert sharded > 0


def test_hybrid_fsdp_equals_flat_and_one_process(four):
    """4 ranks: FSDP over the world (flat) or within the nodes of a 2 x 2
    ``("dcn", "data")`` mesh (each node holds every slice once): the same
    steps, and the one process's on the global batch of 4."""
    _, one, outs, _ = four
    for out in outs:
        assert bit_equal(out["hybrid"]["params"], out["flat"]["params"])
        assert bit_equal(out["hybrid"]["ema"], out["flat"]["ema"])
        assert max_diff(out["flat"]["params"], one["params"]) <= 1e-5
        torch.testing.assert_close(torch.tensor(out["flat"]["grad_norms"]),
                                   torch.tensor(one["grad_norms"]),
                                   rtol=1e-5, atol=0)
        for name, numel in out["hybrid_shard_numel"].items():
            full = out["flat"]["params"][name]
            flat_dim = fsdp_param_spec(full.shape, 4, ranks.FSDP_MIN)
            node_dim = fsdp_param_spec(full.shape, 2, ranks.FSDP_MIN)
            assert numel == (full.numel() if node_dim is None
                             else full.numel() // 2)
            assert out["flat_shard_numel"][name] == (
                full.numel() if flat_dim is None else full.numel() // 4)


def test_fsdp_checkpoint_round_trip_between_two_ranks_and_one(two):
    """Saved by 2 FSDP ranks (rank 0 writes the whole file), it loads
    bit-equal in one process; a one-process file restores into each
    rank's slices."""
    tmp, one, _, outs = two
    fresh = ranks.mvldm_trainer(None, 2, 1)
    restore_checkpoint(str(tmp / "out" / "step_000000002"), fresh.state)
    got = ranks.run_steps(fresh, 0)
    assert bit_equal(got["params"], outs[0]["fsdp"]["params"])
    assert bit_equal(got["ema"], outs[0]["fsdp"]["ema"])
    moments = one.state.optimizer.state_dict()["state"]
    for rank, out in enumerate(outs):
        names = list(one.state.ema_params)
        assert bit_equal(out["restored_params"], {
            n: p.detach() for n, p in one.state.model.named_parameters()})
        for i, name in enumerate(names):
            dim = out["dims"][name]

            def part(x):
                return x if dim is None else x.chunk(2, dim)[rank]

            assert torch.equal(out["restored_ema"][name],
                               part(one.state.ema_params[name]))
            assert torch.equal(out["restored_shards"][name],
                               part(one.state.model.get_parameter(name)))
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(out["restored_opt"][i][k],
                                   part(moments[i][k])), (name, k)


def test_train_main_under_two_ranks(two):
    """``train.main`` under 2 ranks, ``--batch_size 1`` each, equals one
    process with ``--batch_size 2``; rank 0 alone writes the metrics and
    the checkpoint."""
    tmp, _, ref, outs = two
    want = {n: p.detach() for n, p in ref.state.model.named_parameters()}
    for out in outs:
        assert max_diff(out["main_params"], want) <= 1e-5
    lines = (tmp / "main2" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
    assert sorted(p.name for p in (tmp / "main2").iterdir()) == [
        "metrics.jsonl", "step_000000002"]
    saved = restore_checkpoint(str(tmp / "main2" / "step_000000002"))
    assert saved["step"] == 2
    assert max_diff(saved["model"], {
        n: v for n, v in ref.state.model.state_dict().items()}) <= 1e-5
