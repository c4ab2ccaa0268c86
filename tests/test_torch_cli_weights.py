"""The weight-import flags of the port's ``iterative_inference`` twin beside
the JAX CLI at a tiny size (96x128 frames, fc 64, C=11, f32):
``--fcn-reference-npz`` with and without ``--fcn-flip-deconvs`` (a
reference-era positional Lasagne FCN-8) and ``--arch mirror
--dae-mirror-npz`` (a positional mirror DAE) print the JAX CLI's lines
(mIoU and accuracy to 4 decimals); ``--dae-mirror-npz`` without ``--arch
mirror`` gets the JAX CLI's refusal.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.models.registry import init_score_template  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import iterative_inference as tcli  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    cli_lines,
    jax_script,
    lasagne_checkpoint,
    lasagne_positional,
    write_cli_npz,
)

@pytest.fixture(scope="module")
def jcli():
    return jax_script("iterative_inference")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A DAE npz (depth 4), a Lasagne FCN-8 (fc 64) and a Lasagne mirror DAE
    (depth 4, pool4 at the bottleneck: enc1..4, mid, dec4..1, out)."""
    d = tmp_path_factory.mktemp("cli_weights")
    dae = write_cli_npz(d, 0, 4, "full")[2:]
    jparams = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64)
    np.savez(d / "ref.npz", *lasagne_positional(lasagne_checkpoint(jparams, 4)))
    mirror = init_score_template("mirror", jax.random.PRNGKey(1), n_classes=11, h_taps=("pool4",), depth=4)
    rng = np.random.default_rng(6)
    arrays = []
    for name in ("enc1", "enc2", "enc3", "enc4", "mid", "dec4", "dec3", "dec2", "dec1", "out"):
        kh, kw, cin, cout = mirror[name]["w"].shape
        arrays += [rng.normal(size=(cout, cin, kh, kw)).astype(np.float32) * 0.1,
                   rng.normal(size=(cout,)).astype(np.float32) * 0.1]
    np.savez(d / "mirror.npz", *arrays)
    return d, dae


CASES = {
    "fcn_reference": ["--fcn-reference-npz", "{d}/ref.npz", "<dae>"],
    "fcn_reference_flipped": ["--fcn-reference-npz", "{d}/ref.npz", "--fcn-flip-deconvs", "<dae>"],
    "mirror_reference": ["--fcn-reference-npz", "{d}/ref.npz", "--arch", "mirror", "--dae-mirror-npz",
                         "{d}/mirror.npz"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_weight_flags_print_what_the_jax_cli_prints(jcli, weights, case):
    d, dae = weights
    flags = []
    for f in CASES[case]:
        flags += dae if f == "<dae>" else [f.format(d=d)]
    argv = ["--synthetic", "--tiny", "--num-batches", "1", "--batch-size", "2", *flags]
    want = cli_lines(jcli.main, argv)
    got = cli_lines(tcli.main, [*argv, "--device", "cpu"])
    assert got[:2] == want[:2] and got[1].startswith("step 5 (refined):")
    assert len(got) == len(want) == 3 + 11


def test_mirror_npz_needs_the_mirror_arch_as_in_jax(jcli, weights):
    d, _ = weights
    argv = ["--synthetic", "--tiny", "--num-batches", "1", "--dae-mirror-npz", str(d / "mirror.npz")]
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="--dae-mirror-npz requires --arch mirror"):
            main([*argv, *extra])
