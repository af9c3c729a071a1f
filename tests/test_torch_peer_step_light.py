"""The port's train step on the peer-KD recipe with `device_light: true`
and `decoder_loss_weight` 0.5 against JAX's `make_train_step`: uint8 `img`
and `ori` go through the input stage in the step, `img` relit with JAX's
draws and `ori` without relight (two launches of the augment kernel a step
on the card; its plain version here), and the recover decoder runs on
bn2's output, its weighted L2 loss against `ori` joining the total
whatever `kd_loss_weight` is. The machinery, the model and the tolerances
are those of tests/test_torch_peer_step.py (whose host-float run is the
yaml's, decoder loss off)."""

import pytest
import torch

from test_torch_peer_step import (check_bn_stats, check_metrics,
                                  check_teacher_frozen, check_updates,
                                  run_both)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    return run_both(device_light=True, decoder_loss_weight=0.5)


@pytest.mark.parametrize("n", [1, 2])
def test_metrics_match_jax(runs, n):
    check_metrics(runs, n)


@pytest.mark.parametrize("n", [1, 2])
def test_parameter_updates_match_jax(runs, n):
    check_updates(runs, n)


@pytest.mark.parametrize("n", [1, 2])
def test_bn_running_stats_match_jax(runs, n):
    check_bn_stats(runs, n)


def test_teacher_stays_frozen(runs):
    check_teacher_frozen(runs)


@pytest.mark.parametrize("n", [1, 2])
def test_recover_loss_joins_the_total(runs, n):
    """total - cls - lambda1 seg (kd_loss_weight 0) is the weighted
    recover loss, > 0 on both sides."""
    _, jax_out, port_out, _ = runs
    for metrics in (jax_out[n - 1][0], port_out[n - 1][0]):
        rec = (metrics["total_loss"] - metrics["cls_loss"]
               - metrics["seg_loss"])
        assert rec > 1e-3, metrics
