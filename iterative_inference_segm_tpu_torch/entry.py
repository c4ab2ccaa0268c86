"""The port of ``__graft_entry__.entry()``: the flagship forward and its
example arguments, on the card.

``entry()`` returns ``(forward, (fcn_params, dae_params, x))``: FCN-8 at
full width (fc 4096, CamVid's 11 classes, seed 0) + the DAE (pool4, depth
3, stem 1, seed 1), five half-engine score steps, bf16 with the folded
per-step tail (``inference.fused.flagship_forward_fn``), and one zero image
``x`` of (1, 360, 480, 3) f32. ``forward(fcn_params, dae_params, x)`` gives
``y_K`` (1, 360, 480, 11) bf16.

    python -m iterative_inference_segm_tpu_torch.entry
    # entry() OK (1, 360, 480, 11) torch.bfloat16

``dryrun_multichip(n)`` is the port of the JAX file's multi-device dry
run: one process a device (``parallel.launch``), on gloo CPU ranks, or on
the card with the ranks sharing it over gloo (NCCL takes one card a rank).

    python -m iterative_inference_segm_tpu_torch.entry multichip 8 --device cpu
    # dryrun_multichip(8) OK
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn, no_autograd
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8



def flagship_params(device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """The flagship's seeded full-width params, f32 on ``device``: FCN-8 fc
    4096 for CamVid's 11 classes (seed 0) and the DAE on pool4, depth 3,
    stem 1 (seed 1). The serving and training benches run them too."""
    n_classes = 11
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=n_classes, device=device)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=n_classes, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=3, stem_pool=1, device=device)
    return fcn, dae


def entry(device: torch.device | str = "cuda"):
    """``(forward, (fcn_params, dae_params, x))`` on ``device``: the
    flagship forward (FCN-8 + K=5 half-engine refinement, bf16) and its
    example arguments."""
    fcn_params, dae_params = flagship_params(device)
    flagship = flagship_forward_fn(num_steps=5, depth=3)

    def forward(fcn_params, dae_params, x):
        with no_autograd("score"):
            _, y_k = flagship(fcn_params, dae_params, x)
        return y_k

    x = torch.zeros((1, 360, 480, 3), dtype=torch.float32, device=device)
    return forward, (fcn_params, dae_params, x)


def _finite(name: str, t: torch.Tensor) -> torch.Tensor:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"non-finite {name} in the multichip dry run")
    return t


def _dryrun_legs(mesh, device, n: int, workdir: str) -> dict:
    """The legs of ``dryrun_multichip`` in one rank of ``n``; returns what
    each leg produced (rank 0's is printed). ``workdir`` is shared by the
    ranks (the checkpoint leg's)."""
    import torch.distributed as dist

    from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig
    from iterative_inference_segm_tpu_torch.inference.fused import no_autograd
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d
    from iterative_inference_segm_tpu_torch.parallel import pp
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, make_mesh
    from iterative_inference_segm_tpu_torch.parallel.sharding import shard_batch
    from iterative_inference_segm_tpu_torch.parallel.tp import shard_params_tp, tp_shardings
    from iterative_inference_segm_tpu_torch.train.loop import DataParallel, TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_dae import draw_step_randomness, make_dae_train_step
    from iterative_inference_segm_tpu_torch.utils.checkpoint import restore_checkpoint_sharded, save_checkpoint

    even = n % 2 == 0 and n > 1
    tiny = DatasetConfig(name="dryrun", n_classes=5, void_label=5, height=64, width=64, in_channels=3,
                         train_crop=(48, 48), mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                         class_names=("a", "b", "c", "d", "e"))
    tcfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-4)
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=tiny.n_classes, fc_channels=32, device=device)
    batch = max(n, 2 * (n // 2) or 1)
    images = torch.zeros((batch, tiny.height, tiny.width, 3))
    labels = torch.zeros((batch, tiny.height, tiny.width), dtype=torch.int32)
    out = {}

    def dae_step(step_mesh, spatial):
        dae = init_dae(torch.Generator().manual_seed(1), n_classes=tiny.n_classes,
                       h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, device=device)
        step, _ = make_dae_train_step(tiny, tcfg, make_optimizer(tcfg, dae), h_taps=("pool4",), sigma=0.5,
                                      from_gt=True, corruption_impl="kernel", mesh=step_mesh)
        x, y = shard_batch(step_mesh, (images, labels), spatial_axis=spatial)
        gen = torch.Generator().manual_seed(2)
        rand = DataParallel(step_mesh).own(lambda: draw_step_randomness(
            gen, batch=int(x.shape[0]), hw=(tiny.height, tiny.width), crop=tiny.train_crop, p_gt=1.0))
        return float(_finite("loss", step(dae, fcn, x.to(device), y.to(device), rand)))

    # DP x SP: the DAE train step with H over 'space' (('data',) for odd n)
    sp_mesh = make_mesh(("data", "space"), (n // 2, 2)) if even else make_mesh(("data",), (n,))
    out["sp_loss"] = dae_step(sp_mesh, "space" if even else None)
    # the workload CLIs' DP step
    out["dp_loss"] = dae_step(make_mesh(("data",), (n,)), None)

    if even:  # fc6/fc7 tensor-parallel over 'model'
        tp_mesh = make_mesh(("data", "model"), (n // 2, 2))
        x = shard_batch(tp_mesh, images).to(device)
        with torch.no_grad():
            probs, _ = fcn8_apply(shard_params_tp(fcn, tp_mesh), x, model_group=axis_group(tp_mesh, "model"))
        out["tp_probs"] = tuple(_finite("TP probs", probs).shape)

    if n >= 2:  # the flagship pipeline: 2 stages (x DP for even n >= 4), 3 stages, the stacked one
        dae_pp = init_dae(torch.Generator().manual_seed(4), n_classes=tiny.n_classes,
                          h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1, device=device)
        if n >= 4 and even:
            pp_mesh, batch_axis, mb = make_mesh(("data", "stage"), (n // 2, 2)), "data", 2 * (n // 2)
        else:
            pp_mesh, batch_axis, mb = make_mesh(("stage",), (2,), ranks=2), None, 2
        pipes = [("pp2_yk", pp_mesh, batch_axis, 3 * mb, 3)]
        if n >= 3:
            pipes.append(("pp3_yk", make_mesh(("stage",), (3,), ranks=3), None, 4, 2))
        for name, m, axis, b, micro in pipes:
            if m.get_coordinate() is None:
                continue
            fwd = pp.make_pp_flagship(m, eps=0.1, num_steps=2, depth=3, compute_dtype=torch.float32,
                                      batch_axis=axis)
            with no_autograd("score"):
                _, yk = fwd(fcn, dae_pp, pp.split_microbatches(torch.zeros((b, tiny.height, tiny.width, 3),
                                                                            device=device), micro))
            out[name] = tuple(_finite("PP y_k", yk).shape)
        n_stk = 4 if n >= 4 else 2
        stk_mesh = make_mesh(("stage",), (n_stk,), ranks=n_stk)
        if stk_mesh.get_coordinate() is not None:
            chans = 8
            ks = 0.1 * torch.randn((n_stk, chans, chans, 3, 3), generator=torch.Generator().manual_seed(5))
            pipe = pp.make_gpipe_stacked(lambda k, w: {"a": torch.tanh(conv2d(w["a"], k))}, stk_mesh)
            with torch.no_grad():
                got = pipe(pp.stage_slice(ks.to(device), stk_mesh),
                           {"a": torch.zeros((3, 2, 16, 16, chans), device=device)})
            out["stacked"] = tuple(_finite("stacked PP", got["a"]).shape)

    if even:  # a replicated save restored straight onto the fc6/fc7 TP layout
        ck_mesh = make_mesh(("data", "model"), (n // 2, 2))
        if dist.get_rank() == 0:
            save_checkpoint(workdir, 0, fcn)
        dist.barrier()
        shardings = tp_shardings(fcn, ck_mesh)
        restored = restore_checkpoint_sharded(workdir, 0, fcn, shardings)
        want = shardings["fc6"]["w"].local(fcn["fc6"]["w"])
        if not torch.equal(_finite("restored fc6", restored["fc6"]["w"]), want):
            raise AssertionError("the sharded restore did not land on the TP layout")
        out["restored_fc6"] = tuple(restored["fc6"]["w"].shape)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The DAE training step over an ``n_devices`` mesh, one step of each
    parallel path, in ``n_devices`` ranks: DP x SP (H over 'space', for
    even n), DP, fc6/fc7 TP, the 2- and 3-stage flagship pipelines and the
    stacked one, and a replicated save restored onto the TP layout
    (``restore_checkpoint_sharded``). Every leg asserts finite outputs.
    ``device``: 'cpu' (gloo ranks) or a card, which the ranks share over
    gloo. Returns rank 0's legs."""
    from iterative_inference_segm_tpu_torch.parallel.launch import launch
    from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    kernels = ("corruption", "refine_tail") if device.type == "cuda" else ()
    with tempfile.TemporaryDirectory(prefix="multichip-") as td:
        return launch(_dryrun_legs, n_devices, os.path.join(td, "ckpt"), mesh=MeshSpec(("data",), (n_devices,)),
                      device=device, backend="gloo", kernels=kernels)


def main(argv=None) -> int:
    import argparse

    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", nargs="*", help="'multichip [N]': the multi-device dry run in N ranks (8)")
    p.add_argument("--device", default="cuda", help="torch device ('cuda' needs a card)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    if args.command[:1] == ["multichip"]:
        n = int(args.command[1]) if len(args.command) > 1 else 8
        dryrun_multichip(n, args.device)
        print(f"dryrun_multichip({n}) OK")
        return 0
    fn, example = entry(device)
    out = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("entry() OK", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
