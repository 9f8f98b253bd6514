"""Each frozen copy of the yardstick against what it copies: the weight
recipe, the data stream, MATCHA's matrices, the row layout, the FLOP
count and the profiler's kernel classes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import yardstick
from portbench.reference import model as M
from portbench.reference import recipes

DIMS = [M.Dims(2, 64, 4, 2, 128, 256, 1e6, 1e-5), M.Dims(1, 80, 8, 2, 96, 300, 1e4, 1e-5, 16)]


def _cfg(d, n=1):
    from repro_torch.models import ModelConfig

    return ModelConfig(arch_id="t", n_layers=d.n_layers, d_model=d.d_model, n_heads=d.n_heads,
                       n_kv_heads=d.n_kv_heads, d_ff=d.d_ff, vocab_size=d.vocab_size,
                       rope_theta=d.rope_theta, norm_eps=d.norm_eps,
                       sliding_window=d.sliding_window, n_silos=n)


@pytest.mark.parametrize("d", DIMS)
def test_leaf_table_is_the_ports_layout(d):
    from repro_torch.models import ParamLayout, model_specs

    layout = ParamLayout(model_specs(_cfg(d)))
    table = M.leaf_table(d)
    assert [lf.offset for lf in table] == layout.offsets
    assert [lf.shape for lf in table] == [tuple(s) for s in layout.shapes]
    assert [lf.name for lf in table] == [".".join(str(p) for p in path) for path in layout.paths]
    assert M.row_size(d) == layout.size


@pytest.mark.parametrize("d", DIMS)
def test_weight_recipe_is_init_state(d):
    from repro_torch.fed import init_state
    from repro_torch.optim import momentum

    state = init_state(_cfg(d, 3), momentum(0.05), seed=2 ** 40 + 3, device="cpu")
    assert torch.equal(state["params"], M.init_rows(d, 3, 2 ** 40 + 3, "cpu"))
    rows = [r.clone() for r in M.iter_rows(d, 3, 2 ** 40 + 3, "cpu")]
    assert torch.equal(torch.stack(rows), state["params"])


def test_data_stream_is_the_ports():
    from repro_torch.data import FederatedBatcher, SyntheticLMStream

    port = FederatedBatcher(SyntheticLMStream(300, 24, n_silos=5), 2, 3)
    copy = recipes.LMStream(300, 24, 5)
    for r in (0, 1, 7):
        for silos in ((0, 1, 2, 3, 4), (0, 2, 4)):
            a, b = port.batch(r, silos=silos), recipes.stream_batch(copy, r, silos, 2, 3)
            assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("n,budget,seed", [(11, 0.5, 0), (11, 0.5, 2 ** 33 + 1), (4, 0.3, 7)])
def test_matcha_matrices_are_the_ports(n, budget, seed):
    from repro_torch.core import MatchaSchedule, greedy_edge_coloring
    from repro_torch.fed import ScheduleSlot

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    sched = MatchaSchedule(matchings=tuple(tuple(m) for m in greedy_edge_coloring(pairs)),
                           budget=budget, sample_seed=seed)
    slot = ScheduleSlot(sched, n)
    for r in range(40):
        assert np.array_equal(slot.matrix_for_round(r), recipes.matcha_matrix(n, budget, seed, r))


def test_ring_matrix_is_the_ports():
    from repro_torch.fed.topology_runtime import plan_for_n_silos

    for n in (2, 4, 11):
        A = M.ring_matrix_from_arcs([(i, (i + 1) % n) for i in range(n)], n)
        assert np.array_equal(np.asarray(A), plan_for_n_silos("ring", n).matrix)
    with pytest.raises(ValueError):
        M.ring_matrix_from_arcs([(0, 1), (1, 0), (2, 3), (3, 2)], 4)


@pytest.mark.parametrize("d", DIMS + [M.Dims(4, 2048, 16, 8, 8192, 92544, 1e6, 1e-5),
                                      M.Dims(1, 2560, 32, 8, 6912, 32000, 1e4, 1e-5, 4096)])
@pytest.mark.parametrize("S", [32, 1024, 4096, 8192])
def test_flops_are_the_analytic_models(d, S):
    from repro_torch.launch.analytic_model import forward_flops

    assert yardstick.forward_flops(d, S) == pytest.approx(forward_flops(_cfg(d), S, S), rel=1e-12)


def test_kernel_classes_are_the_round_profilers():
    from repro_torch.launch.profile_round import kernel_part

    names = ["gossip_mix_kernel<2>", "sm80_xmma_gemm_f32f32", "void cutlass::Kernel2<x>",
             "Memcpy HtoD (Pageable -> Device)", "Memset (Device)", "index_select_kernel",
             "void at::native::vectorized_elementwise_kernel<4>", "ampere_sgemm_128x64_nn",
             "cublasLt::splitKreduce", "gemv2T_kernel", "sm90_xmma_gemm"]
    assert [yardstick.kernel_part(n) for n in names] == [kernel_part(n) for n in names]
