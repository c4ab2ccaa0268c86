"""The port's subpackages export the JAX package's names.

Each JAX subpackage's ``__init__.py`` is parsed with ``ast`` (not
imported), and every name it imports is found, under the same name, in the
port's subpackage of the same path, or in ``OMITTED`` with the reason it is
left out. The trainers and the model functions the JAX CLIs and
``bench.py`` import this way must be callables, not the submodules of the
same name.
"""

import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

JAX_PKG = pathlib.Path(__file__).resolve().parents[1] / "iterative_inference_segm_tpu"
SUBPACKAGES = ("data", "inference", "models", "ops", "parallel", "train", "utils")

# Names the port does not export, by design, each with its reason.
OMITTED: dict[tuple[str, str], str] = {}


def jax_exports(sub: str) -> list[str]:
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    return [alias.asname or alias.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_in_the_port(sub):
    names = jax_exports(sub)
    assert names, f"the JAX {sub}/__init__.py exports nothing?"
    port = importlib.import_module(f"iterative_inference_segm_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n) and (sub, n) not in OMITTED]
    assert not missing, f"{sub}: {missing}"


def test_trainers_and_models_are_callables_not_modules():
    from iterative_inference_segm_tpu_torch.models import (
        contextmod_apply,
        dae_apply,
        fcn8_apply,
        init_contextmod,
        init_dae,
        init_fcn8,
        init_mirror_dae,
        mirror_dae_apply,
    )
    from iterative_inference_segm_tpu_torch.train import make_optimizer, train_dae, train_fcn8

    fns = (train_dae, train_fcn8, make_optimizer, init_fcn8, fcn8_apply, init_dae, dae_apply, init_mirror_dae,
           mirror_dae_apply, init_contextmod, contextmod_apply)
    for fn in fns:
        assert callable(fn) and not isinstance(fn, type(pathlib)), fn
    assert train_dae.__module__ == "iterative_inference_segm_tpu_torch.train.train_dae"


def test_train_state_is_the_jax_named_tuple_with_the_torch_optimizer():
    """``TrainState`` keeps the JAX fields (step, params, opt_state); its
    ``opt_state`` is the Adam that ``make_optimizer`` builds over ``params``,
    as ``init_train_state`` returns it beside the state (JAX: ``tx``)."""
    import torch

    from iterative_inference_segm_tpu_torch.train import TrainConfig, TrainState, init_train_state

    params = {"conv": {"w": torch.ones(2, 2), "b": torch.zeros(2)}}
    state, opt = init_train_state(params, TrainConfig(learning_rate=0.5, weight_decay=0.1))
    assert TrainState._fields == ("step", "params", "opt_state")
    assert state.step == 0 and state.params is params and state.opt_state is opt
    assert isinstance(opt, torch.optim.Adam)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.1, 0.0]


def test_importing_the_package_loads_no_kernel_build_or_pillow():
    """Importing every subpackage (the re-exports) imports neither JAX nor
    Pillow and loads no kernel library and no native runtime."""
    import subprocess
    import sys

    code = ("import sys, iterative_inference_segm_tpu_torch as p\n"
            "from iterative_inference_segm_tpu_torch import data, inference, models, ops, parallel, train, utils\n"
            "from iterative_inference_segm_tpu_torch.ops import _build\n"
            "from iterative_inference_segm_tpu_torch.data import native_loader\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL', 'iterative_inference_segm_tpu')]\n"
            "print(bad, sorted(_build._loaded), len(native_loader._libs))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=JAX_PKG.parent, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[] [] 0"
