"""The arithmetic of ``scripts/torch_transition_clocks.py``, on the CPU.

The script runs only on the card (it builds the NUTS kernels with their
section clocks); what it computes from the clocks' side buffer is plain
numpy and is held here on buffers whose answers are known: the grid's
tail share from the blocks' start and end times, the sections' shares
and cycles per leaf step from the chains' rows, and the output digest
that tells two checkouts' bits apart.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_transition_clocks.py"
_spec = importlib.util.spec_from_file_location("torch_transition_clocks", _PATH)
tc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tc)


def test_tail_share_of_one_block_a_sm():
    # four blocks on four SMs: busy 10, 10, 5 and 5 of a 10 ns span
    blocks = np.array([[0, 10, 0, 0], [0, 10, 1, 0], [0, 5, 2, 0], [5, 10, 3, 0]],
                      dtype=np.int64)
    out = tc._tail(blocks, n_sms=8)
    assert out["sms_used"] == 4 and out["blocks"] == 4
    assert out["span_ms"] == pytest.approx(10e-6)
    assert out["tail_share"] == pytest.approx(1 - 30 / 40)
    assert out["tail_share_all_sms"] == pytest.approx(1 - 30 / 80)
    assert out["block_ms_max"] == pytest.approx(10e-6)
    assert out["block_ms_mean"] == pytest.approx(7.5e-6)


def test_tail_share_counts_an_sm_from_its_first_start_to_its_last_end():
    # two blocks in turn on SM 0, one on SM 1 that ends early
    blocks = np.array([[0, 4, 0, 0], [4, 12, 0, 0], [0, 3, 1, 0]], dtype=np.int64)
    out = tc._tail(blocks, n_sms=2)
    assert out["sms_used"] == 2
    assert out["tail_share"] == pytest.approx(1 - (12 + 3) / 24)
    assert out["tail_share_all_sms"] == out["tail_share"]


def test_sections_shares_and_cycles_per_leaf_step():
    rows = np.zeros((2, tc.SLOTS), dtype=np.int64)
    rows[0, :len(tc.SECTIONS)] = [40, 10, 0, 10, 0, 0, 40, 0]  # 100 cycles
    rows[1, :len(tc.SECTIONS)] = [80, 20, 0, 20, 0, 0, 0, 80]  # 200 cycles
    rows[:, len(tc.SECTIONS)] = [10, 10]  # leaf steps
    rows[:, len(tc.SECTIONS) + 1] = [5, 10]  # leaves built
    out = tc._sections(rows)
    shares = [out[f"share_{k}"] for k in tc.SECTIONS]
    assert sum(shares) == pytest.approx(1.0)
    assert out["share_body"] == pytest.approx(120 / 300)
    assert out["share_wait"] == pytest.approx(40 / 300)
    assert out["cycles_per_step"] == pytest.approx(300 / 20)
    assert out["cycles_per_step_body"] == pytest.approx(120 / 20)
    assert out["leaf_steps_per_chain"] == 10 and out["leaves_built_per_chain"] == 7.5


def test_digest_tells_bits_apart():
    rng = np.random.default_rng(0)
    out = {"q": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
           "depth": torch.arange(4, dtype=torch.int32), "trace": None}
    same = {k: (v.clone() if v is not None else None) for k, v in out.items()}
    assert tc._digest(out) == tc._digest(same)
    same["q"][2, 1] = float(np.nextafter(np.float32(same["q"][2, 1].item()), np.float32(np.inf)))
    assert tc._digest(out) != tc._digest(same)


@pytest.mark.parametrize("chains,cb", [(1024, 8), (256, 8), (64, 16)])
def test_clock_buffer_holds_a_row_a_chain_and_one_a_block(chains, cb):
    n = tc.clock_buffer_len(chains, cb)
    assert n == chains * tc.SLOTS + (chains // cb) * 4
    # the block rows start where the chains' rows end
    buf = np.zeros(n, np.int64)
    assert buf[chains * tc.SLOTS:].reshape(-1, 4).shape == (chains // cb, 4)


def test_ptxas_entries_group_each_kernels_lines():
    """``chip_smoke._ptxas_entries`` (phase 4's ptxas lines of the moved
    instances) files each stack-frame and register line under the entry
    function ptxas was compiling."""
    import chip_smoke

    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z3fooILi4ELi0ELb1EEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooILi4ELi0ELb1EEvv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 231 registers, 624 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z3fooILi4ELi0ELb0EEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooILi4ELi0ELb0EEvv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, 624 bytes cmem[0]",
    ])
    out = chip_smoke._ptxas_entries(log)
    assert list(out) == ["_Z3fooILi4ELi0ELb1EEvv", "_Z3fooILi4ELi0ELb0EEvv"]
    assert out["_Z3fooILi4ELi0ELb1EEvv"] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 231 registers, 624 bytes cmem[0]"]
    assert "4 bytes spill stores" in out["_Z3fooILi4ELi0ELb0EEvv"][0]


def test_side_rows_parts_of_a_fused_draw_and_products():
    """The fused kernel's side rows: each part of a draw in cycles a
    chain-draw and its share, the share outside the transition, and the
    n x n products a chain-draw; a per-draw launch's rows hold products
    only, one draw a chain."""
    rows = np.zeros((2, tc.SIDE_SLOTS), dtype=np.int64)
    rows[:, :5] = [[10, 20, 60, 5, 5], [30, 20, 100, 15, 5]]  # 270 cycles
    rows[:, tc.SIDE.index("draws")] = [2, 2]
    rows[:, tc.SIDE.index("products")] = [40, 52]
    out = tc._side(rows, 250)
    assert out["products_per_chain_draw"] == pytest.approx(92 / 4)
    assert out["draw_cycles_momentum"] == pytest.approx(40 / 4)
    assert out["draw_cycles_tree"] == pytest.approx(160 / 4)
    assert sum(out[f"draw_share_{k}"] for k in tc.SIDE[:5]) == pytest.approx(1.0)
    assert out["draw_share_outside_transition"] == pytest.approx(110 / 270)
    per_draw = np.zeros((4, tc.SIDE_SLOTS), dtype=np.int64)
    per_draw[:, tc.SIDE.index("products")] = [46, 46, 23, 23]
    assert tc._side(per_draw, 1) == {"products_per_chain_draw": pytest.approx(34.5)}


def test_side_rows_count_the_lowrank_metrics_velocities():
    """For the low-rank metric the side rows' products slot counts its
    velocities (a velocity, or the fused momentum's thin matvecs), and the
    record names them so; a fused launch's parts are as for the others."""
    per_draw = np.zeros((4, tc.SIDE_SLOTS), dtype=np.int64)
    per_draw[:, tc.SIDE.index("products")] = [30, 30, 14, 14]
    assert tc._side(per_draw, 1, "lowrank") == {"velocities_per_chain_draw": pytest.approx(22.0)}
    fused = np.zeros((2, tc.SIDE_SLOTS), dtype=np.int64)
    fused[:, :5] = [[10, 20, 60, 5, 5], [30, 20, 100, 15, 5]]
    fused[:, tc.SIDE.index("draws")] = [250, 250]
    fused[:, tc.SIDE.index("products")] = [8000, 9000]
    out = tc._side(fused, 250, "lowrank")
    assert "products_per_chain_draw" not in out
    assert out["velocities_per_chain_draw"] == pytest.approx(17000 / 500)
    assert out["draw_share_outside_transition"] == pytest.approx(110 / 270)


@pytest.mark.parametrize("kind", ["diag", "lowrank"])
def test_metric_state_of_a_final_states_potential(kind):
    """``metric_state``: the variances alone for a diagonal metric; for the
    pooled low-rank metric also the scales and the factor block built from
    row 0's basis, eigenvalues and bulk (the L1 and L2 cases read them)."""
    from littlemcmc_torch.ops.nuts_trajectory import build_lowrank_fac, lowrank_fac_size
    from littlemcmc_torch.quadpotential import (QuadPotentialDiagAdapt,
                                                QuadPotentialLowRankAdapt)

    C_, n = 16, 6
    rng = np.random.default_rng(3)
    mean = torch.from_numpy(rng.standard_normal((C_, n)).astype(np.float32))
    diag = torch.from_numpy(rng.uniform(0.5, 2.0, (C_, n)).astype(np.float32))
    if kind == "diag":
        pot = QuadPotentialDiagAdapt.create(mean, diag, 10.0)
    else:
        pot = QuadPotentialLowRankAdapt.create(mean, diag, 10.0, rank=2)
    out = tc.metric_state(pot, n)
    if kind == "diag":
        assert list(out) == ["var"] and out["var"] is pot.var
        return
    assert list(out) == ["var", "stds", "fac"]
    assert out["var"] is pot.var and out["stds"] is pot.stds
    assert out["fac"].shape == (lowrank_fac_size(n),)
    torch.testing.assert_close(out["fac"], build_lowrank_fac(pot.vecs[0], pot.lam[0],
                                                             pot.alpha[0]), rtol=0, atol=0)


def test_eight_schools_state_files_hold_the_cells_final_states(tmp_path, monkeypatch):
    """The eight-schools cases start from the final states of
    ``chip_smoke.py``'s NUTS cell (10,240 chains, 500 + 500,
    ``target_accept=0.95``) and its per-draw twin, each in a file of its
    own; ``_final_state`` samples a state once with the cell's keywords
    (here on the CPU at 16 chains, 30 + 20, the twin's ``fuse_draws=False``)
    and loads it after, the same tensors."""
    import chip_smoke
    import littlemcmc_torch as lt
    from littlemcmc_torch.models import EightSchools

    assert {"es_fused", "es_twin"} <= set(tc.STATE_FILES)
    assert len(set(tc.STATE_FILES.values())) == len(tc.STATE_FILES)
    es = EightSchools(device="cpu")
    path = tmp_path / tc.STATE_FILES["es_twin"]
    kw = dict(chains=16, tune=30, draws=20, device="cpu", fuse_draws=False,
              step=lt.NUTS(model_ndim=10, target_accept=chip_smoke.ES_TARGET))
    state = tc._final_state(path, es, **kw)
    assert path.exists()
    assert set(state) == {"q", "grad", "logp", "var", "p", "iter", "log_step", "log_bar", "hbar",
                          "count", "mu"}
    assert state["q"].shape == state["p"].shape == state["var"].shape == (16, 10)
    assert (state["iter"] == 50.0).all() and torch.isfinite(state["logp"]).all()
    monkeypatch.setattr(lt, "sample", lambda *a, **k: pytest.fail("sampled a kept state again"))
    again = tc._final_state(path, es, **kw)
    for k in state:
        torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)


def test_tail_skips_rows_of_blocks_that_never_ran():
    """The HMC per-draw cases bind a block row for every chain (their
    thread blocks may hold fewer chains than the NUTS kernels'): the rows
    no block wrote (end 0) are left out of the tail."""
    blocks = np.array([[0, 10, 0, 0], [0, 5, 1, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
                      dtype=np.int64)
    out = tc._tail(blocks, n_sms=2)
    assert out["blocks"] == 2 and out["sms_used"] == 2
    assert out["tail_share"] == pytest.approx(1 - 15 / 20)


def test_hmc_sections_shares_steps_and_wait():
    """The HMC kernels' rows: each section's share of the chains' cycles
    (``HMC_SECTIONS``), its cycles a lockstep step, the wait share, and the
    steps a chain-draw, its block's lockstep steps and its own."""
    rows = np.zeros((2, tc.SLOTS), dtype=np.int64)
    rows[0, :len(tc.HMC_SECTIONS)] = [60, 0, 20, 5, 0, 0, 0, 15]  # 100 cycles, all live
    rows[1, :len(tc.HMC_SECTIONS)] = [24, 0, 8, 5, 0, 0, 50, 13]  # 100, half of it frozen
    rows[:, len(tc.HMC_SECTIONS)] = [8, 8]  # the block's lockstep steps over 2 draws
    rows[:, len(tc.HMC_SECTIONS) + 1] = [8, 3]  # each chain's own
    out = tc._hmc_sections(rows, 2)
    assert sum(out[f"share_{k}"] for k in tc.HMC_SECTIONS) == pytest.approx(1.0)
    assert out["wait_share"] == out["share_wait"] == pytest.approx(50 / 200)
    assert out["share_body"] == pytest.approx(84 / 200)
    assert out["cycles_per_step"] == pytest.approx(200 / 16)
    assert out["cycles_per_step_wait"] == pytest.approx(50 / 16)
    assert out["lockstep_steps_per_chain_draw"] == pytest.approx(4.0)
    assert out["steps_per_chain_draw"] == pytest.approx(11 / 4)


@pytest.mark.parametrize("shape", ["one_draw", "draws"])
def test_hmc_step_counts_and_each_blocks_longest(shape):
    """The step counts' mean and largest, and each block's largest a draw
    (the steps a lockstep block runs), a last block that is not full
    included."""
    counts = np.array([1, 5, 3, 2, 9, 1, 1, 1, 4, 4])  # blocks of 4: 5, 9, 4
    if shape == "draws":
        counts = np.stack([counts, np.ones_like(counts)])  # a second draw: 1, 1, 1
    out = tc._hmc_step_counts(counts, 4)
    assert out["mean_steps"] == pytest.approx(counts.mean())
    assert out["max_steps"] == 9
    want = 6.0 if shape == "one_draw" else (6.0 + 1.0) / 2
    assert out["block_max_steps_per_draw"] == pytest.approx(want)
    assert out["lockstep_step_ratio"] == pytest.approx(want / counts.mean())


def test_hmc_steps_as_the_sampler_draws_them():
    """``hmc_steps``: floor(U * path_length / eps) clamped to [1,
    max_steps], the uniforms from a seeded generator: the same counts
    again, a step past the path length gives 1, a tiny step max_steps."""
    from littlemcmc_torch.base import HMCConfig

    cfg = HMCConfig(max_steps=50)
    eps = torch.tensor([0.25, 0.1, 10.0, 1e-6])
    n = tc.hmc_steps(eps, cfg, seed=3)
    torch.testing.assert_close(n, tc.hmc_steps(eps, cfg, seed=3), rtol=0, atol=0)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand(4, generator=gen) * cfg.path_length
    torch.testing.assert_close(n, torch.clamp(torch.floor(u / eps), 1, 50).to(torch.int32))
    assert n.dtype == torch.int32 and int(n[2]) == 1 and int(n[3]) == 50


def test_hmc_state_files_hold_the_cells_final_states(tmp_path, monkeypatch):
    """The HMC cases start from the final states of HMC's main path and of
    HMC ``adapt_full``, each in a file of its own; ``_final_state`` samples
    the main path's once with ``HamiltonianMC`` (here on the CPU at 16
    chains, 30 + 20) and loads it after, the same tensors."""
    import littlemcmc_torch as lt
    from littlemcmc_torch.models import CorrelatedGaussian

    assert {"hmc", "hmc_adapt_full"} <= set(tc.STATE_FILES)
    assert len(set(tc.STATE_FILES.values())) == len(tc.STATE_FILES)
    model = CorrelatedGaussian(6, device="cpu")
    path = tmp_path / tc.STATE_FILES["hmc"]
    kw = dict(chains=16, tune=30, draws=20, device="cpu", step=lt.HamiltonianMC(model_ndim=6))
    state = tc._final_state(path, model, **kw)
    assert path.exists()
    assert set(state) == {"q", "grad", "logp", "var", "p", "iter", "log_step", "log_bar", "hbar",
                          "count", "mu"}
    assert state["q"].shape == state["var"].shape == (16, 6)
    steps = tc.hmc_steps(torch.exp(state["log_bar"]), lt.base.HMCConfig())
    assert steps.shape == (16,) and int(steps.min()) >= 1
    monkeypatch.setattr(lt, "sample", lambda *a, **k: pytest.fail("sampled a kept state again"))
    again = tc._final_state(path, model, **kw)
    for k in state:
        torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)


def test_hmc_ptxas_instances_name_the_block_and_warp_ones():
    """``chip_smoke._hmc_moved_instances`` (phase 4's ptxas lines of the HMC
    kernels' block instances): body 1's per-draw block instance and the
    fused kernel's dense block and warp instances, keyed as the NUTS ones,
    and no other instance."""
    import chip_smoke

    def entry(name, regs):
        return [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{name}EEvNS_4ArgsE'"
                " for 'sm_90a'", "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill"
                " loads", f"ptxas info    : Used {regs} registers"]

    log = "\n".join(entry("27hmc_trajectory_block_kernelILi1E", 90)
                    + entry("21hmc_trajectory_kernelILi0E", 40)
                    + entry("16fused_hmc_kernelILi1ELi1ELb1E", 158)
                    + entry("16fused_hmc_kernelILi1ELi1ELb0E", 106)
                    + entry("16fused_hmc_kernelILi1ELi0ELb0E", 64))
    out = chip_smoke._hmc_moved_instances(log)
    assert list(out) == ["<1,0,block>", "<1,1,block>", "<1,1,warp>"]
    assert out["<1,1,block>"][1].endswith("Used 158 registers")
    assert out["<1,1,warp>"][1].endswith("Used 106 registers")


def test_hmc_tune_chunk_as_the_per_chain_metric_cells_run_it(monkeypatch):
    """``hmc_tune_chunk`` (the cases ``hmc_l3_tune`` and ``hmc_es_tune``):
    the fused HMC op's inputs for a tune chunk with the step size adapting
    and the per-chain Welford steps swapping windows at draw 2; the
    low-rank one with the spiked Gaussian's spikes as the factor. Here made
    on the CPU and run through the plain op, at 16 chains."""
    import chip_smoke
    from littlemcmc_torch.models import EightSchools, SpikedGaussian
    from littlemcmc_torch.ops.fused_hmc import fused_hmc
    from littlemcmc_torch.ops.fused_nuts import WELFORD_KEYS
    from littlemcmc_torch.ops.nuts_trajectory import lowrank_fac_size

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for model, metric, ta in ((SpikedGaussian(12, device="cpu"), "lowrank", None),
                              (EightSchools(device="cpu"), "diag", 0.95)):
        args, words, kw = tc.hmc_tune_chunk(model, 16, 41, metric, ta)
        assert len(args) == 11 and args[0].shape == (16, model.ndim) and args[10] is None
        assert kw["T"] == 4 and kw["tuning"] and kw["config"].adapt_step_size
        assert kw["config"].target_accept == (0.8 if ta is None else ta)
        assert kw["metric"] == metric and kw["window_multiplier"] == 2.0
        assert len(kw["welford"]) == len(WELFORD_KEYS)
        # the windows swap at the chunk's draw 2: n_samples 48, window 50
        assert float(kw["welford"][-2][0]) == 48.0 and float(kw["welford"][-1][0]) == 50.0
        if metric == "lowrank":
            assert kw["fac"].shape == (lowrank_fac_size(model.ndim),)
        else:
            assert "fac" not in kw
        out = fused_hmc(*args, words, spec=model.trajectory_spec(), chain_block=8, **kw)
        assert out["n_steps"].shape == (4, 16) and (out["window"] == 100.0).all()
        # the same inputs again: the case's seed fixes them
        again = tc.hmc_tune_chunk(model, 16, 41, metric, ta)
        torch.testing.assert_close(again[0][0], args[0], rtol=0, atol=0)


def test_rows_4b_4c_state_files_and_cases():
    """L3 and eight schools' HMC cell keep their final states in files of
    their own; the four cases of rows 4c and 4b name the fused HMC op, and
    ``kinds_only`` names each case's kernel without sampling (what the
    instrumented build compiles)."""
    assert {"l3", "hmc_es"} <= set(tc.STATE_FILES)
    assert len(set(tc.STATE_FILES.values())) == len(tc.STATE_FILES)
    kinds = tc._inputs(_PATH.parents[1], _PATH.parent, None, kinds_only=True)
    for case in ("hmc_l3_final", "hmc_l3_tune", "hmc_es_final", "hmc_es_tune"):
        assert kinds[case] == "fused_hmc"
    assert set(kinds.values()) == set(tc.KINDS)
    assert tc._inputs(_PATH.parents[1], _PATH.parent, ["hmc_es_tune"], kinds_only=True) == {
        "hmc_es_tune": "fused_hmc"}


def test_hmc_ptxas_instances_name_the_register_instances():
    """``chip_smoke._hmc_moved_instances`` keys the fused HMC kernel's
    register instances (the low-rank one and eight schools' packed one)
    and the low-rank warp instance kept for larger blocks."""
    import chip_smoke

    def entry(name, regs, spill=0):
        return [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{name}EEvNS_4ArgsE'"
                " for 'sm_90a'", f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
                "bytes spill loads", f"ptxas info    : Used {regs} registers"]

    log = "\n".join(entry("24fused_hmc_lowrank_kernelILi4E", 200)
                    + entry("23fused_hmc_packed_kernelILi2E", 64)
                    + entry("16fused_hmc_kernelILi4ELi2ELb0E", 128)
                    + entry("16fused_hmc_kernelILi4ELi0ELb0E", 126))
    out = chip_smoke._hmc_moved_instances(log)
    assert list(out) == ["<4,2,registers>", "<2,0,packed>", "<4,2,warp>"]
    assert out["<4,2,registers>"][1].endswith("Used 200 registers")
    assert out["<2,0,packed>"][1].endswith("Used 64 registers")
