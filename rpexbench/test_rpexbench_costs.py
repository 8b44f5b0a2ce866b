"""The frozen yardsticks: each kernel's FLOPs and bytes at the models'
shapes against the figures the port's kernel table gives (B=8, S=1024,
bf16), and model FLOPs a token against the port's own accounting."""
import json
from pathlib import Path

import pytest

from rpexbench.costs import flash_bwd, flash_fwd, model_flops, ssd_chunk, \
    ssd_chunk_bwd
from rpexbench.costs.peaks import bound_s

HERE = Path(__file__).resolve().parent
CONFIGS = [c["name"] for c in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["configs"]]


def model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("fn, dims, gflop, mb", [
    (ssd_chunk.cost, (8, 1024, 64, 64, 128, 256), 17.483, 276.83),
    (ssd_chunk_bwd.cost, (8, 1024, 64, 64, 128, 256), 35.235, 354.43),
    (flash_fwd.cost, (8, 1024, 1024, 16, 8, 128), 34.393, 100.66),
    (flash_bwd.cost, (8, 1024, 1024, 16, 8, 128), 85.983, 201.85),
])
def test_kernel_costs_match_the_kernel_table(fn, dims, gflop, mb):
    flops, nbytes = fn(*dims)
    assert round(flops / 1e9, 3) == gflop
    assert round(nbytes / 1e6, 2) == mb


def test_bounds_at_the_table_shapes():
    assert round(bound_s(*ssd_chunk.cost(8, 1024, 64, 64, 128, 256)) * 1e3,
                 4) == 0.0826
    assert round(bound_s(*flash_fwd.cost(8, 1024, 1024, 16, 8, 128)) * 1e3,
                 4) == 0.0348


def test_window_and_offset_pairs():
    # a window keeps W(W+1)/2 + (S-W)W pairs a head; an offset moves rows
    assert flash_fwd.attention_pairs(8, 8, window=3) == 3 * 4 // 2 + 5 * 3
    assert flash_fwd.attention_pairs(4, 8, q_offset=4) == 5 + 6 + 7 + 8


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("training", [True, False])
def test_model_flops_match_the_port(name, training):
    from repro_torch.configs.base import ModelConfig
    m = model(name)
    assert model_flops.per_token(m, training) == \
        ModelConfig(**m).model_flops_per_token(training)


def test_model_flops_of_moe_and_hybrid():
    from repro_torch.configs import get_config
    for arch in ("qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
                 "gemma2-9b", "internvl2-76b"):
        cfg = get_config(arch)
        m = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
        assert model_flops.per_token(m, True) == \
            cfg.model_flops_per_token(True)
