"""The starting parameters are the benchmark's own: made from the seed by
the configuration's init, the same for a seed and different across seeds,
of the leaves, shapes and dtypes the program holds, and loaded into it."""

import math

import pytest
import torch

import tiny_cells
from benchlib import weights

CELLS = {"linear.train": tiny_cells.tiny_linear,
         "ssl.train": tiny_cells.tiny_ssl}
SEED = 2 ** 31 + 7


def _made(cell, seed=SEED):
    ref = cell.reference()
    return weights.make(ref.param_specs(cell.config),
                        ref.store_dtype(cell.config), seed,
                        torch.device("cpu"))


def _program(cell):
    from video_spike_torch.core.config import DictConfig
    from video_spike_torch.core.registry import NAME2MODEL

    cfg = DictConfig(cell.config["config"])
    name = cell.config.get("model_name", cfg.model.get("model_class"))
    return NAME2MODEL[name].from_config(cfg.model, device="cpu")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_same_seed_same_weights_other_seed_other(name):
    cell = CELLS[name]()
    a, b, c = _made(cell), _made(cell), _made(cell, SEED + 1)
    assert set(a) == set(b) == set(c)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    drawn = [k for k, (_, init, _) in
             cell.reference().param_specs(cell.config).items()
             if init in ("lecun", "normal")]
    assert drawn and all(not torch.equal(a[k], c[k]) for k in drawn)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_program_holds_the_reference_leaves(name):
    cell = CELLS[name]()
    made = _made(cell)
    model = _program(cell)
    params = {k: p.detach() for k, p in model.named_parameters()}
    for k, v in made.items():
        params[k].data = params[k].data.to(v.dtype)
    host = weights.load(params, made)
    for k, v in made.items():
        assert torch.equal(params[k], v) and torch.equal(host[k], v), k


def test_lecun_and_token_draws_follow_the_init():
    cell = tiny_cells.tiny_ssl()
    specs = cell.reference().param_specs(cell.config)
    made = _made(cell)
    k = "vit_mae.encoder.Block_0.Dense_0.kernel"
    shape, init, fan = specs[k]
    x = made[k].double()
    std = math.sqrt(1.0 / fan)
    assert init == "lecun"
    assert abs(float(x.std()) / std - 1) < 0.1
    assert float(x.abs().max()) <= 2 * std / weights.TRUNC_STD + 1e-6
    assert torch.equal(made["vit_mae.encoder.LayerNorm_0.scale"],
                       torch.ones_like(made["vit_mae.encoder.LayerNorm_0"
                                            ".scale"]))
    assert float(made["vit_mae.encoder.Block_0.Dense_0.bias"].abs().max()) \
        == 0.0


def test_linear_store_dtypes():
    cell = tiny_cells.tiny_linear()
    made = _made(cell)
    assert made["encoder.Dense_0.kernel"].dtype == torch.bfloat16
    assert made["encoder.Dense_0.bias"].dtype == torch.float32


def test_load_refuses_a_leaf_the_reference_does_not_list():
    cell = tiny_cells.tiny_linear()
    made = _made(cell)
    program = {k: v.clone() for k, v in made.items()}
    program["extra"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="only in the program"):
        weights.load(program, made)
    program = {k: v.float() for k, v in made.items()}
    with pytest.raises(RuntimeError, match="configuration states"):
        weights.load(program, made)
