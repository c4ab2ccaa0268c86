"""The port's ``iterative_inference`` CLI against the JAX package's
``scripts/iterative_inference.py`` on ``--synthetic --tiny --num-batches 1``
(96x128 frames, fc 64, C=11), both given the same ``--fcn-npz`` /
``--dae-npz`` written by the JAX package: in f32 they print the same k=0
and k=K lines (mIoU and accuracy to 4 decimals), with and without
``--search``, and with ``--arch mirror --dae-tied`` and ``--arch
contextmod``. The flags refused until their modules were ported are
accepted (sharded and pipeline serving run in ``test_torch_cli_parallel.py``),
and ``--wire u8`` alone gets the JAX CLI's refusal. The data flags' seams
are in ``test_torch_cli_data.py``.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.models.registry import checkpoint_meta, init_score_template  # noqa: E402
from iterative_inference_segm_tpu.utils.checkpoint import save_npz  # noqa: E402

from iterative_inference_segm_tpu_torch.scripts import iterative_inference as tcli  # noqa: E402
from torch_port_helpers import cli_lines, jax_script, write_cli_npz  # noqa: E402

@pytest.fixture(scope="module")
def jcli():
    return jax_script("iterative_inference")


@pytest.mark.parametrize("extra", [
    [],
    ["--search", "--k-max", "3", "--eps-grid", "0.1", "0.3"],
    ["--engine", "half", "--search", "--k-max", "2", "--eps-grid", "0.1", "0.3"],
])
def test_cli_prints_what_the_jax_cli_prints(jcli, tmp_path, extra):
    half = "half" in extra
    weights = write_cli_npz(tmp_path, 1 if half else 0, 3 if half else 4, "full")
    argv = ["--synthetic", "--tiny", "--num-batches", "1", *weights, *extra]
    want = cli_lines(jcli.main, argv)
    got = cli_lines(tcli.main, [*argv, "--device", "cpu"])
    n = 3 if "--search" in extra else 2  # [val search line,] k=0 line, k=K line
    assert got[:n] == want[:n]
    assert got[n] == want[n] == "per-class IoU (k=0 -> k=K):"
    assert len(got) == len(want) == n + 1 + 11
    assert [ln.split(":")[0] for ln in got[n + 1:]] == [ln.split(":")[0] for ln in want[n + 1:]]
    if "--search" in extra:
        assert got[0].startswith("val search: best eps=")
    assert got[n - 2].startswith("step 0 (FCN-8 baseline): mIoU ")


def test_cli_energy_sep_half_runs(tmp_path):
    weights = write_cli_npz(tmp_path, 1, 3, "sep")
    lines = cli_lines(tcli.main, ["--synthetic", "--tiny", "--num-batches", "1", "--device", "cpu", *weights,
                               "--engine", "half", "--mode", "energy", "--num-steps", "2"])
    assert lines[1].startswith("K=2+rectify (half engine):")


# refused until the mirror DAE and the context module, the data path,
# utils/ and parallel/ were ported; none is refused now
PORTED_FLAGS = (["--arch", "mirror"], ["--arch", "contextmod"], ["--dae-tied"], ["--data-root", "x"],
                ["--packed", "x"], ["--dae-mirror-npz", "x"], ["--fcn-reference-npz", "x"],
                ["--fcn-flip-deconvs"], ["--dump-dir", "x"], ["--dump-trajectory"], ["--devices", "2"], ["--pp"],
                ["--pp-stages", "3"], ["--pp-microbatches", "4"])


@pytest.mark.parametrize("flags", [
    ["--data-root", "x"], ["--packed", "x"], ["--wire", "u8"], ["--devices", "2"], ["--pp"],
    ["--pp-stages", "3"], ["--pp-microbatches", "4"], ["--arch", "mirror"], ["--arch", "contextmod"],
    ["--dae-tied"], ["--dae-mirror-npz", "x"], ["--fcn-reference-npz", "x"], ["--fcn-flip-deconvs"],
    ["--dump-dir", "x"], ["--dump-trajectory"],
])
def test_cli_rejects_unported_flags_naming_the_roadmap(flags, capsys, jcli):
    if flags in PORTED_FLAGS:
        args = tcli.parse_args(flags)
        assert str(vars(args)[flags[0][2:].replace("-", "_")]) == (flags[1] if len(flags) > 1 else "True")
        return
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flags == ["--wire", "u8"]:  # the JAX CLI's own refusal
        assert "--wire u8 requires --packed" in err
        with pytest.raises(SystemExit):
            jcli.parse_args(flags)
        assert "--wire u8 requires --packed" in capsys.readouterr().err
        return
    assert "ROADMAP.md, Queue 1 item 12" in err


@pytest.mark.parametrize("flags,match", [
    (["--engine", "half"], "--dae-stem-pool >= 1"),
    (["--engine", "half", "--dae-stem-pool", "1", "--dae-depth", "3", "--renorm", "softmax"], "general-engine"),
])
def test_cli_keeps_the_jax_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--synthetic", "--tiny", "--num-batches", "1", "--batch-size", "1", "--device", "cpu", *flags])


def test_cli_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["--synthetic", "--tiny", "--num-batches", "1"])


@pytest.mark.parametrize("arch", ["mirror_tied", "contextmod"])
def test_cli_with_the_other_score_networks_prints_what_the_jax_cli_prints(jcli, tmp_path, arch):
    """--arch mirror --dae-tied and --arch contextmod (on the input tap),
    both CLIs given the same JAX-written weights: the same k=0 and k=K lines."""
    write_cli_npz(tmp_path, 0, 4, "full")  # the FCN; the DAE npz is replaced below
    name, tied = arch.split("_")[0], arch.endswith("_tied")
    taps = ("input",) if name == "contextmod" else ("pool4",)
    net = init_score_template(name, jax.random.PRNGKey(2), n_classes=11, h_taps=taps, depth=4, tied=tied)
    rng = np.random.default_rng(1)
    net = {k: {kk: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1) if kk == "b" else v)
               for kk, v in lv.items()} for k, lv in net.items()}
    save_npz(tmp_path / "net.npz", net, meta=checkpoint_meta(name, h_taps=taps, depth=4, tied=tied))
    argv = ["--synthetic", "--tiny", "--num-batches", "1", "--fcn-npz", str(tmp_path / "fcn.npz"),
            "--dae-npz", str(tmp_path / "net.npz"), "--arch", name, "--concat-h", *taps,
            *(["--dae-tied"] if tied else [])]
    want = cli_lines(jcli.main, argv)
    got = cli_lines(tcli.main, [*argv, "--device", "cpu"])
    assert got[:2] == want[:2] and got[1].startswith("step 5 (refined):")
