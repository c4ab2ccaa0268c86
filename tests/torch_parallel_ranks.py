"""What the parallel tests run inside their ranks (``parallel.launch``).

This module imports neither jax nor the JAX package: every rank imports it
afresh. The tests compute the JAX side in their own process and hand the
ranks numpy inputs (params in the JAX layout, batches, each device's
draws); a rank returns numpy results. ``run_cases`` runs several cases in
one launch, so that a test file pays for few process groups.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

from iterative_inference_segm_tpu_torch.parallel import dp, pp, sharding, tp
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_index, axis_size, make_mesh
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax


def run_cases(mesh, device, cases):
    """``cases``: ``[(name, function name in this module, kwargs)]``; each
    runs as ``fn(mesh, device, **kwargs)``. Returns ``{name: result}``."""
    return {name: globals()[fn](mesh, device, **kw) for name, fn, kw in cases}


def raises(call) -> str:
    """The message of what ``call`` raises (its type and text), or ''."""
    try:
        call()
    except Exception as e:  # the tests match the type and the text
        return f"{type(e).__name__}: {e}"
    return ""


def count_calls(module, name):
    """Wrap ``module.name`` to count its calls; returns the counter list."""
    counter = [0]
    inner = getattr(module, name)

    def wrapped(*a, **kw):
        counter[0] += 1
        return inner(*a, **kw)

    setattr(module, name, wrapped)
    return counter


def fail_on_rank(mesh, device, rank: int):
    if dist.get_rank() == rank:
        raise ValueError(f"boom from rank {rank}")
    dist.barrier()
    return dist.get_rank()


def whoami(mesh, device):
    return {"rank": dist.get_rank(), "device": str(device), "backend": dist.get_backend(),
            "names": tuple(mesh.mesh_dim_names), "print": print(f"printed by rank {dist.get_rank()}")}


# ------------------------------------------------------------------ mesh, sharding


def mesh_basics(mesh, device):
    out = {"size": axis_size(mesh, "data"), "index": axis_index(mesh, "data"),
           "bad_sizes": raises(lambda: make_mesh(("data",), (3,))),
           "no_axis": raises(lambda: axis_size(mesh, "stage"))}
    two = make_mesh(("data", "model"), (1, 2))
    out["two"] = (axis_size(two, "data"), axis_size(two, "model"), axis_index(two, "model"))
    return out


def shard_and_replicate(mesh, device, x, y):
    xs, ys = sharding.shard_batch(mesh, (x, torch.from_numpy(y)))
    params = {"a": {"w": torch.full((3,), float(dist.get_rank() + 1))}}
    sharding.replicate(mesh, params)
    place = sharding.batch_sharding(mesh, 4)
    return {"x": xs, "y": ys.numpy(), "replicated": params["a"]["w"].numpy(),
            "gathered": sharding.gather_batch(mesh, torch.from_numpy(np.ascontiguousarray(xs))).numpy(),
            "placements": [type(p).__name__ for p in place.placements],
            "replicated_placements": [type(p).__name__ for p in sharding.replicated_sharding(mesh).placements]}


def putter(mesh, device, x, y, void_label):
    put = sharding.padded_batch_putter(mesh, void_label=void_label)
    xb, yb = put(x, y)
    # the padded size is pinned by the first batch
    xb2, yb2 = put(x[:1], y[:1])
    return {"x": xb.numpy(), "y": yb.numpy(), "x2_shape": tuple(xb2.shape), "y2": yb2.numpy()}


def prefetch_sharded(mesh, device, items):
    from iterative_inference_segm_tpu_torch.data.prefetch import device_prefetch

    place = sharding.batch_sharding(mesh, 4)
    return [{k: v.numpy() for k, v in it.items()}
            for it in device_prefetch(items, depth=2, device=device, sharding=place)]


# ------------------------------------------------------------------ dp


def _fcn8_loss(n_classes):
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_logits
    from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy

    def loss_fn(params, batch, rand):
        return masked_crossentropy(fcn8_logits(params, batch["images"]), batch["labels"], n_classes=n_classes)

    return loss_fn


def dp_grad_step(mesh, device, jparams, images, labels, n_classes, lr):
    """``make_dp_grad_step`` with SGD on FCN-8 over this rank's shard; the
    number of all_reduce calls the step made."""
    params = params_from_jax(jparams)
    for t in dp.leaves(params):
        t.requires_grad_(True)
    opt = torch.optim.SGD(dp.leaves(params), lr=lr)
    params, batch = dp.put_dp(mesh, params, {"images": torch.from_numpy(images),
                                             "labels": torch.from_numpy(labels)})
    step = dp.make_dp_grad_step(_fcn8_loss(n_classes), opt, mesh)
    calls = count_calls(dist, "all_reduce")
    loss = step(params, batch, None)
    return {"loss": float(loss), "params": params_to_jax(params), "all_reduce_calls": calls[0]}


def dp_rng_and_mean(mesh, device, draws, targets):
    """The per-rank randomness and the average: ``w * draw`` with each
    rank's own draw (JAX's ``fold_in(rng, d)``), and mean((w - t)^2) over
    sharded targets, under SGD(1.0)."""
    params = {"p": {"w": torch.zeros((), requires_grad=True)}}
    step = dp.make_dp_grad_step(lambda p, b, r: p["p"]["w"] * r, torch.optim.SGD(dp.leaves(params), lr=1.0), mesh)
    step(params, None, torch.tensor(draws[axis_index(mesh, "data")]))
    params2 = {"p": {"w": torch.zeros(4, requires_grad=True)}}
    step2 = dp.make_dp_grad_step(lambda p, b, r: torch.mean((p["p"]["w"][None, :] - b[:, None]) ** 2),
                                 torch.optim.SGD(dp.leaves(params2), lr=1.0), mesh)
    step2(params2, sharding.shard_batch(mesh, torch.from_numpy(targets)), None)
    return {"w": float(params["p"]["w"]), "w_mean": params2["p"]["w"].detach().numpy()}


def dae_dp_step(mesh, device, cfg, jfcn, jdae, images, labels, train_rand, eval_seeds, step_kw):
    """One DP DAE eval step and one train step (eval first: the train step
    updates the params in place) over this rank's shard, with the draws JAX
    device d took; Adam's first moment after the step."""
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_dae import StepRandomness, make_dae_train_step

    fcn_t, dae_t = params_from_jax(jfcn), params_from_jax(jdae)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg, dae_t)
    train_step, eval_step = make_dae_train_step(cfg, tcfg, opt, corruption_impl="kernel", mesh=mesh, **step_kw)
    r = axis_index(mesh, "data")
    x, y = sharding.shard_batch(mesh, (torch.from_numpy(images), torch.from_numpy(labels)))
    cm, vloss = eval_step(dae_t, fcn_t, x, y, StepRandomness(eval_seeds[r]))
    seed, crop = train_rand[r]
    crop = tuple(torch.from_numpy(a) for a in crop) if crop is not None else None
    calls = count_calls(dist, "all_reduce")
    loss = train_step(dae_t, fcn_t, x, y, StepRandomness(seed, crop=crop))
    mu = params_to_jax({l: {k: opt.state[t]["exp_avg"] for k, t in lv.items()} for l, lv in dae_t.items()})
    return {"loss": float(loss), "mu": mu, "cm": cm.numpy(), "val_loss": float(vloss), "all_reduce_calls": calls[0]}


def fcn_dp_step(mesh, device, cfg, jparams, images, labels, rands, fc):
    """One DP FCN-8 eval step and train step over this rank's shard, with
    the crops and keep-masks JAX device d drew; and, for the DP contract,
    Adam's first moment of single-device steps on each shard, averaged."""
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import StepRandomness, make_fcn8_train_step

    def rand_of(r):
        masks, crop = rands[r]
        return StepRandomness(dropout=tuple(torch.from_numpy(m) for m in masks),
                              crop=tuple(torch.from_numpy(a) for a in crop))

    def moments(params, opt):
        return params_to_jax({l: {k: opt.state[t]["exp_avg"] for k, t in lv.items()} for l, lv in params.items()})

    params = params_from_jax(jparams)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg, params)
    train_step, eval_step = make_fcn8_train_step(cfg, tcfg, opt, fc_channels=fc, mesh=mesh)
    x, y = sharding.shard_batch(mesh, (torch.from_numpy(images), torch.from_numpy(labels)))
    cm, vloss = eval_step(params, x, y)
    loss = train_step(params, x, y, rand_of(axis_index(mesh, "data")))
    shard_mus = []
    n = axis_size(mesh, "data")
    k = images.shape[0] // n
    for r in range(n):
        single = params_from_jax(jparams)
        opt1 = make_optimizer(tcfg, single)
        step1, _ = make_fcn8_train_step(cfg, tcfg, opt1, fc_channels=fc)
        step1(single, torch.from_numpy(images[r * k : (r + 1) * k]), torch.from_numpy(labels[r * k : (r + 1) * k]),
              rand_of(r))
        shard_mus.append(moments(single, opt1))
    mean_mu = {l: {kk: np.mean([m[l][kk] for m in shard_mus], axis=0) for kk in lv} for l, lv in shard_mus[0].items()}
    return {"loss": float(loss), "params": params_to_jax(params), "mu": moments(params, opt), "mu_shards": mean_mu,
            "cm": cm.numpy(), "val_loss": float(vloss)}


def fcn_eval_padded(mesh, device, cfg, jparams, images, labels, fc):
    """The DP eval step on a short batch padded by the putter, against the
    single-device step on the real rows."""
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import make_fcn8_train_step

    params = params_from_jax(jparams)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg, params)
    _, eval_dp = make_fcn8_train_step(cfg, tcfg, opt, fc_channels=fc, mesh=mesh)
    _, eval_one = make_fcn8_train_step(cfg, tcfg, opt, fc_channels=fc)
    xb, yb = sharding.padded_batch_putter(mesh, void_label=cfg.void_label)(images, labels)
    cm_dp, loss = eval_dp(params, xb, yb)
    cm_one, _ = eval_one(params, torch.from_numpy(images), torch.from_numpy(labels))
    return {"cm_dp": cm_dp.numpy(), "cm_one": cm_one.numpy(), "loss": float(loss), "local_rows": int(xb.shape[0])}


def trainers_dp(mesh, device, cfg, workdir, fc, seed):
    """Both trainers for two epochs under the mesh into one workdir each:
    what rank 0 wrote, and each rank's params' checksum."""
    from pathlib import Path

    from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_dae import train_dae
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import train_fcn8

    def data(n, s):
        # 5 rows a batch: the last shard is padded under a mesh of 2
        return lambda: synthetic_batches(cfg=cfg, batch_size=5, num_batches=n, height=48, width=64, seed=s)

    tcfg = TrainConfig(max_epochs=2, seed=seed)
    # every rank starts from other weights: the trainer must broadcast rank 0's
    fcn = init_fcn8(torch.Generator().manual_seed(seed + dist.get_rank()), n_classes=cfg.n_classes,
                    fc_channels=fc)
    r_fcn = train_fcn8(dataset=cfg, train_data=data(2, 1), val_data=data(1, 2), tcfg=tcfg, fc_channels=fc,
                       workdir=str(Path(workdir) / "fcn"), params=fcn, mesh=mesh)
    r_dae = train_dae(fcn_params=r_fcn["params"], dataset=cfg, train_data=data(2, 3), val_data=data(1, 4),
                      tcfg=tcfg, dae_depth=3, dae_stem_pool=1, dae_widths=(8, 16, 32),
                      workdir=str(Path(workdir) / "dae"), mesh=mesh)
    checksum = lambda p: float(sum(float(t.double().sum()) for lv in p.values() for t in lv.values()))  # noqa: E731
    return {"fcn": checksum(r_fcn["params"]), "dae": checksum(r_dae["params"]),
            "fcn_history": r_fcn["history"], "dae_history": r_dae["history"]}


def predictor_dp(mesh, device, cfg, jfcn, jdae, images, kw):
    from iterative_inference_segm_tpu_torch.inference.predictor import Predictor

    p = Predictor(params_from_jax(jfcn), params_from_jax(jdae), device=device, dataset=cfg, mesh=mesh,
                  compute_dtype=torch.float32, **kw)
    labels, probs = p.predict(images, return_probs=True)
    return {"labels": labels, "probs": probs,
            "indivisible": raises(lambda: Predictor(params_from_jax(jfcn), None, device=device, dataset=cfg,
                                                    mesh=mesh, batch_size=3))}


def prebuild_count(mesh, device, packed, cfg):
    """The native runtime's compiles in this rank while it trains one DP
    epoch from a packed file (the parent built it before the spawn)."""
    from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.ops import _build
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import train_fcn8

    import subprocess

    calls = count_calls(subprocess, "run")  # _build runs the compiler through it
    ds = NativeDataset(packed)
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=cfg.n_classes, fc_channels=16)
    train_fcn8(dataset=cfg, train_data=lambda: ds.batches(4), val_data=lambda: ds.batches(4),
               tcfg=TrainConfig(max_epochs=1), fc_channels=16, params=fcn, normalize=False, mesh=mesh)
    return {"compiles": calls[0], "build_dir": str(_build.BUILD_DIR)}


# ------------------------------------------------------------------ tp


def tp_cases(mesh, device, jparams, images, labels, masks, lr):
    """FCN-8 with fc6/fc7 over the 'model' axis: the layout, the forward
    (plain and with the whole dropout masks), the gradients, one Adam step
    and what each rank holds."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, fcn8_logits
    from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group

    whole = params_from_jax(jparams)
    specs = tp.tp_shardings(whole, mesh)
    local = tp.shard_params_tp(whole, mesh)
    group = axis_group(mesh, "model")
    x = torch.from_numpy(images)
    with torch.no_grad():
        probs, _ = fcn8_apply(local, x, model_group=group)
        logits_masked = fcn8_logits(local, x, dropout=tuple(torch.from_numpy(m) for m in masks), model_group=group)
    for t in dp.leaves(local):
        t.requires_grad_(True)
    opt = torch.optim.Adam(dp.leaves(local), lr=lr)
    loss = masked_crossentropy(fcn8_logits(local, x, model_group=group), torch.from_numpy(labels),
                               n_classes=int(jparams["score_fr"]["w"].shape[-1]))
    loss.backward()
    grads = params_to_jax({l: {k: t.grad for k, t in lv.items()} for l, lv in local.items()})
    opt.step()
    moments = {name: tuple(opt.state[local[name]["w"]]["exp_avg"].shape) for name in ("fc6", "fc7", "conv1_1")}
    return {
        "layout": {name: {k: [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
                              for p in specs[name][k].placements] for k in ("w", "b")}
                   for name in ("fc6", "fc7", "conv1_1")},
        "shapes": {name: tuple(local[name]["w"].shape) for name in ("fc6", "fc7", "score_fr")},
        "probs": probs.numpy(), "logits_masked": logits_masked.numpy(), "loss": float(loss),
        "grads": grads, "params": params_to_jax(local), "moments": moments,
        "bytes": sum(t.numel() * t.element_size() for name in ("fc6", "fc7") for t in local[name].values()),
        "indivisible": raises(lambda: tp.tp_shardings({"fc6": {"w": torch.zeros(17, 1, 1, 1)}}, mesh)),
        "model_index": axis_index(mesh, "model"),
    }


def tp_with_data(mesh, device, jparams, images):
    """TP composed with a 'data' axis: ('data', 'model') of (1, 2)."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group

    both = make_mesh(("data", "model"), (1, 2))
    local = tp.shard_params_tp(params_from_jax(jparams), both)
    x = sharding.shard_batch(both, torch.from_numpy(images))
    with torch.no_grad():
        probs, _ = fcn8_apply(local, x, model_group=axis_group(both, "model"))
    return sharding.gather_batch(both, probs).numpy()


# ------------------------------------------------------------------ pp


def gpipe_toy(mesh, device, params, xs):
    """The two-stage toy of the JAX tests at each M in ``xs``."""
    k0, k1 = (torch.from_numpy(p) for p in params)

    def s0(p, w, x):
        return {**w, "a": torch.tanh(x["a"] @ p)}

    def s1(p, w, x):
        return {**w, "a": w["a"] @ p + 1.0}

    pipe = pp.make_gpipe((s0, s1), mesh)
    sends = count_calls(dist, "isend")
    out = [pipe((k0, k1), {"a": torch.from_numpy(x)}, {"a": torch.zeros(x.shape[1:])})["a"].numpy() for x in xs]
    isend_calls = sends[0]
    errors = {
        "count": raises(lambda: pp.make_gpipe((s0, s1, s1), mesh)),
        "no_axis": raises(lambda: pp.make_gpipe((s0, s1), make_mesh(("data",), (2,)))),
        "no_axis_stacked": raises(lambda: pp.make_gpipe_stacked(s0, make_mesh(("data",), (2,)))),
        "no_axis_flagship": raises(lambda: pp.make_pp_flagship(make_mesh(("data",), (2,)), eps=0.1, num_steps=2)),
        "width": raises(lambda: pp.make_pp_flagship(make_mesh(("data", "stage"), (2, 1)), eps=0.1, num_steps=2)),
        "renorm": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=2, renorm="softmax")),
        "knobs": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=2, engine="general", fold_tail=True)),
        "engine": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=2, engine="fused")),
        "arch": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=2, dae_arch="mirror")),
    }
    x0 = torch.from_numpy(xs[0])

    def grad(make, *, remat):  # d sum(out ** 2) / d k0, through the pipeline make(remat) builds
        k = k0.clone().requires_grad_(True)
        return torch.autograd.grad(torch.sum(make(remat)(k) ** 2), [k])[0].numpy()

    def het(remat):
        return lambda k: pp.make_gpipe((s0, s1), mesh, remat=remat)((k, k1), {"a": x0}, {"a": torch.zeros(x0.shape[1:])})["a"]

    def stacked(remat):
        stage = pp.make_gpipe_stacked(lambda p, w: {**w, "a": torch.tanh(w["a"] @ p)}, mesh, remat=remat)
        return lambda k: stage(torch.stack([k, k1]), {"a": x0})["a"]

    grads = {"grad": grad(het, remat=False), "remat": (grad(het, remat=True), grad(het, remat=False)),
             "remat_stacked": (grad(stacked, remat=True), grad(stacked, remat=False))}
    return {"out": out, "isend_calls": isend_calls, "stage": axis_index(mesh, "stage"), "errors": errors,
            "grads": grads}


def gpipe_stacked(mesh, device, stacked, x, batch_axis=None, resident=False, mesh_shape=None):
    """``make_gpipe_stacked`` on the launch's mesh, or on ``mesh_shape``
    (names, sizes) formed over the same ranks."""
    if mesh_shape is not None:
        mesh = make_mesh(*mesh_shape)
    ks = torch.from_numpy(stacked)
    params = pp.stage_slice(ks, mesh) if resident else ks
    pipe = pp.make_gpipe_stacked(lambda p, w: {**w, "a": torch.tanh(w["a"] @ p)}, mesh, batch_axis=batch_axis)
    return {"out": pipe(params, {"a": torch.from_numpy(x)})["a"].numpy(), "held": tuple(params.shape)}


def flagship(mesh, device, jfcn, jdae, images, microbatches, kw, batch_axis=None):
    """``make_pp_flagship`` on split microbatches: (y0, yk) merged back, f32."""
    from iterative_inference_segm_tpu_torch.inference.fused import no_autograd

    kw = dict(kw)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[kw.pop("compute_dtype", "float32")]
    fwd = pp.make_pp_flagship(mesh, compute_dtype=dtype, batch_axis=batch_axis, **kw)
    with no_autograd(kw.get("mode", "score")):
        y0, yk = fwd(params_from_jax(jfcn), params_from_jax(jdae),
                     pp.split_microbatches(torch.from_numpy(images), microbatches))
    return {"y0": pp.merge_microbatches(y0).float().numpy(), "yk": pp.merge_microbatches(yk).float().numpy()}


def flagship_errors(mesh, device):
    return {"taps": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=3, h_taps=("fc7",))),
            "rank5": raises(lambda: pp.make_pp_flagship(mesh, eps=0.1, num_steps=1)({}, {}, torch.zeros(2, 4, 4, 3)))}


def predictor_pp(mesh, device, cfg, jfcn, jdae, images, kw):
    from iterative_inference_segm_tpu_torch.inference.predictor import Predictor

    fcn, dae = params_from_jax(jfcn), params_from_jax(jdae)
    p = Predictor(fcn, dae, device=device, dataset=cfg, pp_mesh=mesh, compute_dtype=torch.float32, **kw)
    labels, probs = p.predict(images, return_probs=True)
    base = dict(device=device, dataset=cfg, batch_size=4)
    errors = {
        "both": raises(lambda: Predictor(fcn, dae, mesh=mesh, pp_mesh=mesh, **base)),
        "no_dae": raises(lambda: Predictor(fcn, None, pp_mesh=mesh, **base)),
        "microbatches": raises(lambda: Predictor(fcn, dae, pp_mesh=mesh, pp_microbatches=0, **base)),
        "indivisible": raises(lambda: Predictor(fcn, dae, pp_mesh=mesh, pp_microbatches=3, **base)),
    }
    return {"labels": labels, "probs": probs, "errors": errors}


# ------------------------------------------------------------------ CLIs


def cli_lines(mesh, device, module, argv):
    """A CLI twin's ``main`` in this group, on a mesh formed as its flags
    ask; its printed lines."""
    import importlib

    from iterative_inference_segm_tpu_torch.parallel.mesh import mesh_from_flag

    cli = importlib.import_module(f"iterative_inference_segm_tpu_torch.scripts.{module}")
    args = cli.parse_args(argv)
    spec = (cli.pp_mesh_spec(args) if getattr(args, "pp", False)
            else mesh_from_flag(args.devices, batch_size=args.batch_size, device_type="cpu"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, mesh=make_mesh(spec.axis_names, spec.axis_sizes), device=device)
    return {"rc": rc, "lines": buf.getvalue().splitlines()}


# ------------------------------------------------------------------ pp gradients


def _grads_of(loss, params):
    """``loss``'s gradient for every leaf of the port's ``params`` trees, in
    the JAX layout (numpy)."""
    leaves = [t for tree in params for layer in tree.values() for t in layer.values()]
    got = iter(torch.autograd.grad(loss, leaves))
    return [params_to_jax({k: {kk: next(got) for kk in v} for k, v in tree.items()}) for tree in params]


def gpipe_grad(mesh, device, params, x, remat=False):
    """The two-stage toy's gradient of sum(out ** 2) in (k0, k1), and in the
    stream."""
    ks = [torch.from_numpy(p).requires_grad_(True) for p in params]
    xs = torch.from_numpy(x).requires_grad_(True)

    def s0(p, w, x):
        return {**w, "a": torch.tanh(x["a"] @ p)}

    def s1(p, w, x):
        return {**w, "a": w["a"] @ p + 1.0}

    out = pp.make_gpipe((s0, s1), mesh, remat=remat)(tuple(ks), {"a": xs}, {"a": torch.zeros(x.shape[1:])})["a"]
    grads = torch.autograd.grad(torch.sum(out**2), ks + [xs])
    return [g.numpy() for g in grads]


def stacked_grad(mesh, device, stacked, x, remat=False, resident=False, batch_axis=None, mesh_shape=None):
    """``make_gpipe_stacked``'s gradient of sum(out ** 2) in the stacked
    params (a resident slice: this rank's own slice's gradient)."""
    if mesh_shape is not None:
        mesh = make_mesh(*mesh_shape)
    ks = torch.from_numpy(stacked)
    params = (pp.stage_slice(ks, mesh) if resident else ks.clone()).requires_grad_(True)
    pipe = pp.make_gpipe_stacked(lambda p, w: {**w, "a": torch.tanh(w["a"] @ p)}, mesh, batch_axis=batch_axis,
                                 remat=remat)
    (g,) = torch.autograd.grad(torch.sum(pipe(params, {"a": torch.from_numpy(x)})["a"] ** 2), [params])
    return {"grad": g.numpy(), "stage": axis_index(mesh, "stage")}


def flagship_grad(mesh, device, jfcn, jdae, images, microbatches, kw, remat=False, batch_axis=None,
                  wrt=("fcn", "dae")):
    """The gradient of mean(y_K ** 2) through ``make_pp_flagship`` in the
    params named in ``wrt`` (JAX layout), f32."""
    fwd = pp.make_pp_flagship(mesh, compute_dtype=torch.float32, batch_axis=batch_axis, remat=remat, **kw)
    nets = {"fcn": params_from_jax(jfcn), "dae": params_from_jax(jdae)}
    for name in wrt:
        for layer in nets[name].values():
            for t in layer.values():
                t.requires_grad_(True)
    _, yk = fwd(nets["fcn"], nets["dae"], pp.split_microbatches(torch.from_numpy(images), microbatches))
    loss = torch.mean(torch.square(pp.merge_microbatches(yk)))
    grads = _grads_of(loss, [nets[name] for name in wrt])
    return {"loss": loss.item(), **dict(zip(wrt, grads))}
