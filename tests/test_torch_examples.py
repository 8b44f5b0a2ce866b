"""The reference's examples ported to ``repro_torch.examples``: each
``spmd`` body on a 4-rank CPU world against the reference's body on jax's
one CPU device, then each example's ``main()`` to its end with its own
asserts."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DataFlowKernel, PilotDescription, RPEXExecutor
from repro_torch.examples import (colmena_ensemble, heterogeneous_pilots,
                                  iwp_pipeline, quickstart, train_smollm)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _reference(name):
    """``examples/<name>.py`` of the reference, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_mesh():
    """The reference's sub-mesh on its one CPU device, as its executor
    carves a block of slots there."""
    import jax
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def dfk():
    """A 4-rank world for the module's bodies (8 slots: a 4-slot block is
    ranks 0-3, a 2-slot block two of them)."""
    ex = RPEXExecutor(PilotDescription(n_slots=8, ranks=4,
                                       devices=[torch.device("cpu")]))
    with DataFlowKernel(executors={"rpex": ex}) as d:
        yield d


@pytest.mark.timeout(120)
def test_quickstart_body_matches_reference(dfk):
    """``parallel_norm``: ||arange(16) * 2||^2 over a (4, 1) block, each rank
    summing its quarter and a psum adding them, against the reference's
    body within 1e-5 relative."""
    ref = _reference("quickstart")
    want = float(ref.parallel_norm.__wrapped_app__(_jax_mesh(),
                                                   {"scale": 2.0}, 16))
    got = quickstart.parallel_norm({"scale": 2.0}, 16).result()
    assert got.ranks == (0, 1, 2, 3)
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.timeout(120)
def test_colmena_simulate_matches_reference(dfk):
    """``simulate`` at 4 decks: each rank of a 2-rank block averages its half
    of the grid and a pmean averages the halves; the objective within 1e-6
    of the reference's (f32 both)."""
    ref = _reference("colmena_ensemble")
    decks = [ref.pre_process.__wrapped_app__(x) for x in (0.3, 1.1, 1.7, 2.9)]
    futs = [colmena_ensemble.simulate(d) for d in decks]
    for deck, fut in zip(decks, futs):
        want = ref.simulate.__wrapped_app__(_jax_mesh(), deck)
        got = fut.result()
        assert got["x"] == want["x"]
        assert abs(got["y"] - want["y"]) <= 1e-6


@pytest.mark.timeout(120)
def test_iwp_scores_match_reference(dfk):
    """``infer`` on 3 images (tiles seeded with numpy): each rank scores its
    2 of 8 tiles through ``conv2d`` (padding 2) and the scores are gathered
    over "data"; within 1e-6 of the reference's ``convolve2d`` scores."""
    ref = _reference("iwp_pipeline")
    for i in range(3):
        payload = iwp_pipeline.load_and_tile.__wrapped_app__(i)
        want = ref.infer.__wrapped_app__(_jax_mesh(), payload)["scores"]
        got = iwp_pipeline.infer(payload).result()
        assert got["image_id"] == i
        scores = got["scores"].fetch().numpy()
        assert scores.shape == (iwp_pipeline.TILES_PER_IMG,)
        np.testing.assert_allclose(scores, np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("example,argv", [
    (quickstart, CPU),
    (colmena_ensemble, CPU),
    (iwp_pipeline, CPU),
    (heterogeneous_pilots, CPU),
    (train_smollm, ["--tiny"] + CPU),
], ids=["quickstart", "colmena_ensemble", "iwp_pipeline",
        "heterogeneous_pilots", "train_smollm"])
def test_example_main_runs_to_its_end(example, argv):
    """Each ported example's ``main()`` on the CPU: a 4-rank world for its
    spmd tasks (train_smollm: the train driver's own pilot), its own
    asserts holding."""
    assert example.main(argv) is not None
