"""Port parity for the serve driver, reduced configs on the CPU.

In f32 and with the same params, the port's continuous-batching loop gives
the reference's greedy tokens, token for token, for the dense smollm-360m,
the pure-Mamba2 mamba2-1.3b, the MoE qwen3-moe-235b-a22b and dbrx-132b,
the jamba hybrid (Mamba2, attention and MoE layers), gemma2-9b (its local
layers' window of 8 cuts in prompts of up to 63 tokens), musicgen-large,
internlm2-1.8b, granite-3-2b and internvl2-76b (served text only, as the
reference serves it: decode takes no patches).  The reference runs in f32 because the
test hands ``repro.launch.serve`` a ``get_config`` that returns an f32
config (monkeypatch); no reference file changes.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.launch.serve as rserve
from repro.configs import get_config as r_get_config
from repro.configs import reduce_config as r_reduce
from repro.models import transformer as RT
from repro_torch import params as P
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve as tserve

ARGS = ["--arch", "smollm-360m", "--reduced", "--requests", "6",
        "--batch-slots", "3", "--max-new", "6"]


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b",
                                  "qwen3-moe-235b-a22b", "dbrx-132b",
                                  "jamba-1.5-large-398b", "gemma2-9b",
                                  "musicgen-large", "internvl2-76b",
                                  "internlm2-1.8b", "granite-3-2b"])
def test_serve_outputs_equal_reference_f32(monkeypatch, arch):
    argv = ARGS[2:] + ["--arch", arch]
    f32 = lambda name: dataclasses.replace(r_get_config(name), dtype="float32")
    monkeypatch.setattr(rserve, "get_config", f32)
    want = rserve.main(argv)
    # the params the reference's main made: same seed, same config
    cfg = r_reduce(f32(arch))
    tree = jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.PRNGKey(0)))
    args = tserve.parse_args(argv + ["--device", "cpu"])
    tcfg = dataclasses.replace(reduce_config(get_config(arch)), dtype="float32")
    got = tserve.run(tcfg, P.from_numpy_tree(tree, device="cpu"), args)
    assert got == want


def test_serve_driver_end_to_end():
    """The contract of tests/test_system.py::test_serve_driver_end_to_end."""
    outputs = tserve.main(ARGS + ["--device", "cpu"])
    assert len(outputs) == 6
    assert all(len(v) >= 1 for v in outputs.values())
