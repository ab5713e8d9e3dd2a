"""The chained loop ``iterate`` on the CPU: the step function a card
captures in CUDA graphs runs eagerly here, against the exact-f64 oracle's
chain y_k = A·(x + eps·y_{k-1}) (rel 5e-6, the suite's bound), for a
single-vector x and the degree-split hybrid's tuple x; and the graphs'
replay plan covers every step count."""
import numpy as np
import pytest

from ehyb_spmv_gpu_tpu.core.coo import deterministic_x, oracle_spmv
from ehyb_spmv_gpu_tpu.io import generate

import ehyb_spmv_torch as port
from ehyb_spmv_torch.models.base import UNROLL, replay_plan
from test_torch_parity import coo_for, rel

ORACLE_TOL = 5e-6
EPS = 0.1


@pytest.fixture(scope="module")
def models(scrambled):
    heavy = generate.random_general(2000, 8, seed=1, power_law=0.8)
    flagship = port.EhybSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", scrambled))
    split = port.DegreeSplitSpmv(port.EhybConfig(), device="cpu").setup(
        coo_for("ehyb_spmv_torch", heavy))
    return {"flagship": (flagship, scrambled), "split": (split, heavy)}


def oracle_chain(m, x, n: int, eps: float) -> np.ndarray:
    y = oracle_spmv(m, x)
    for _ in range(n - 1):
        y = oracle_spmv(m, x + eps * y)
    return y


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("which", ["flagship", "split"])
def test_iterate_matches_the_oracle_chain(models, which, n):
    model, m = models[which]
    x = deterministic_x(m.dimension)
    x_dev = model.prepare_x(x)
    assert isinstance(x_dev, tuple) == (which == "split")
    got = model.recover_y(model.iterate(x_dev, n, eps=EPS))
    assert rel(got, oracle_chain(m, x, n, EPS)) <= ORACLE_TOL
    # eps = 0: every step reads the last y and still gives one product
    assert np.array_equal(model.recover_y(model.iterate(x_dev, n)),
                          model.matvec(x))


def test_iterate_leaves_x_alone(models):
    model, m = models["flagship"]
    x_dev = model.prepare_x(deterministic_x(m.dimension))
    before = x_dev.clone()
    model.iterate(x_dev, 3, eps=EPS)
    assert bool((x_dev == before).all())


def test_replay_plan_covers_every_step_count():
    for n in list(range(1, 100)) + [500, 2000]:
        plan = replay_plan(n)
        assert sum(u * times for u, times in plan) == n
        assert all(u in UNROLL and times > 0 for u, times in plan)
        assert sum(times for _, times in plan) <= n // UNROLL[0] + 6
