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


def run_groups(mesh, device, groups):
    """``groups``: ``[(axis names, sizes, cases)]``; each group's cases run
    as in ``run_cases`` on a mesh over the launch's first ``prod(sizes)``
    ranks, by those ranks alone. Returns ``{sizes: {name: result}}`` of the
    groups this rank took part in."""
    out = {}
    for names, sizes, cases in groups:
        sub = make_mesh(names, sizes, ranks=int(np.prod(sizes)))
        if sub.get_coordinate() is not None:
            out[tuple(sizes)] = run_cases(sub, device, cases)
    return out


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


def pipeline_misuse(mesh, device):
    """The pipelines on meshes without a 'stage' axis, or one too narrow,
    formed over every rank of the launch."""
    n = dist.get_world_size()

    def stage(p, w, x):
        return w

    return {
        "no_axis": raises(lambda: pp.make_gpipe((stage, stage), make_mesh(("data",), (n,)))),
        "no_axis_stacked": raises(lambda: pp.make_gpipe_stacked(stage, make_mesh(("data",), (n,)))),
        "no_axis_flagship": raises(lambda: pp.make_pp_flagship(make_mesh(("data",), (n,)), eps=0.1, num_steps=2)),
        "width": raises(lambda: pp.make_pp_flagship(make_mesh(("data", "stage"), (n, 1)), eps=0.1, num_steps=2)),
    }


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


# ------------------------------------------------------------------ spatial (H) sharding


@contextlib.contextmanager
def comm_log():
    """Every collective the spatial ops make through ``parallel.comm``
    while the block runs: ``{"isend": [(this group rank, peer)], "irecv":
    [...], "all_gather_cat": n, "all_reduce_": n}``."""
    from iterative_inference_segm_tpu_torch.parallel import comm

    log = {"isend": [], "irecv": [], "all_gather_cat": 0, "all_reduce_": 0}
    saved = {name: getattr(comm, name) for name in log}

    def peer_call(name):
        def call(t, peer, group, **kw):
            log[name].append((dist.get_rank(group), peer))
            return saved[name](t, peer, group, **kw)

        return call

    def counted(name):
        def call(*a, **kw):
            log[name] += 1
            return saved[name](*a, **kw)

        return call

    comm.isend, comm.irecv = peer_call("isend"), peer_call("irecv")
    comm.all_gather_cat, comm.all_reduce_ = counted("all_gather_cat"), counted("all_reduce_")
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(comm, name, fn)


def _space_mesh(shape):
    return make_mesh(("data", "space"), shape)


def _whole(mesh, t):
    return sharding.gather_batch(mesh, t.contiguous(), spatial_axis="space").float().numpy()


def spatial_forwards(mesh, device, jfcn, jdae_g, jdae_h, x, x40):
    """FCN-8's forward on ('data', 'space') (2, 2) and (1, 4) with the
    collectives it made; the general engine (K = 3, and at H = 40 on (2,
    2)) and the half engine (K = 2) on (1, 4); each whole (gathered after
    the forward), with rank 0's unsharded run beside."""
    from iterative_inference_segm_tpu_torch.inference.fused import make_half_refiner
    from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply
    from iterative_inference_segm_tpu_torch.models.registry import score_apply_fn
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group
    from iterative_inference_segm_tpu_torch.parallel.spatial import rows_of

    fcn, dae_g, dae_h = params_from_jax(jfcn), params_from_jax(jdae_g), params_from_jax(jdae_h)
    one = dist.get_rank() == 0
    out = {}
    for name, shape in (("fcn22", (2, 2)), ("fcn14", (1, 4))):
        mesh = _space_mesh(shape)
        xs = sharding.shard_batch(mesh, torch.from_numpy(x), spatial_axis="space")
        with torch.no_grad(), comm_log() as log:
            probs, _ = fcn8_apply(fcn, xs, space=rows_of(axis_group(mesh, "space"), xs))
        out[name] = {"probs": _whole(mesh, probs), "log": log}
    general = dict(eps=0.2, num_steps=3, h_taps=("pool4",))
    half = dict(eps=0.3, num_steps=2, h_taps=("pool4",), depth=3)
    for name, shape, images, make, dae, kw in (
            ("general14", (1, 4), x, make_refiner, dae_g, general),
            ("general40", (2, 2), x40, make_refiner, dae_g, dict(general, num_steps=2)),
            ("half14", (1, 4), x, make_half_refiner, dae_h, half)):
        mesh = _space_mesh(shape)
        args = (fcn8_apply, score_apply_fn("dae"), fcn, dae) if make is make_refiner else (fcn8_apply, fcn, dae)
        xs = sharding.shard_batch(mesh, torch.from_numpy(images), spatial_axis="space")
        y0, yk = make(*args, space_group=axis_group(mesh, "space"), **kw)(xs)
        out[name] = {"y0": _whole(mesh, y0), "yk": _whole(mesh, yk)}
        if one:
            ref = make(*args, **kw)(torch.from_numpy(images))
            out[name]["unsharded"] = tuple(t.float().numpy() for t in ref)
    if one:
        out["fcn_unsharded"] = fcn8_apply(fcn, torch.from_numpy(x))[0].numpy()
    return out


def spatial_ops(mesh, device, heights):
    """Each sharded op against the op on the whole map, forward and
    backward (f64), on ('data', 'space') (1, 4) and (2, 2) at ``heights``
    (1..3 rows over 4 shards leave some empty); the worst error of each."""
    from iterative_inference_segm_tpu_torch.ops import conv as C
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group
    from iterative_inference_segm_tpu_torch.parallel.spatial import Rows

    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    w3, w7, w1, b = rnd(3, 4, 3, 3), rnd(3, 4, 7, 7), rnd(3, 4, 1, 1), rnd(3)
    wt4, wt16, wd3, wdt4 = rnd(4, 4, 4, 4), rnd(4, 4, 16, 16), rnd(4, 1, 3, 3), rnd(4, 1, 4, 4)
    ops = {
        "conv3": lambda t, sp: C.conv2d(t, w3, b, space=sp),
        "conv3_stride2": lambda t, sp: C.conv2d(t, w3, b, stride=2, space=sp),
        "conv7": lambda t, sp: C.conv2d(t, w7, b, space=sp),
        "conv1": lambda t, sp: C.conv2d(t, w1, b, space=sp),
        "conv3_dilated": lambda t, sp: C.conv2d(t, w3, b, dilation=2, space=sp),
        "deconv_k4s2": lambda t, sp: C.conv_transpose2d(t, wt4, stride=2, space=sp),
        "deconv_k16s8": lambda t, sp: C.conv_transpose2d(t, wt16, stride=8, space=sp),
        "depthwise": lambda t, sp: C.conv2d_depthwise(t, wd3, space=sp),
        "depthwise_deconv": lambda t, sp: C.conv_transpose2d_depthwise(t, wdt4, stride=2, space=sp),
        "max_pool": lambda t, sp: C.max_pool(t, space=sp),
        "max_unpool": lambda t, sp: C.max_unpool(C.max_pool(t, space=sp) * 2.0 + 1.0, t, space=sp),
        "avg_pool": lambda t, sp: C.avg_pool(t, space=sp),
        "crop": lambda t, sp: C.crop_to(t, (sp.height if sp else t.shape[1]) - 3, 5, space=sp),
    }
    worst = {}
    for shape in ((1, 4), (2, 2)):
        m = _space_mesh(shape)
        group, n, i = axis_group(m, "space"), shape[1], m.get_local_rank("space")
        for height in heights:
            x = rnd(2, height, 7, 4)
            rows = Rows(group, n, i, height)
            lo, hi = rows.span
            for name, op in ops.items():
                if (name == "avg_pool" and height < 2) or (name == "crop" and height < 4):
                    continue
                whole = x.clone().requires_grad_(True)
                ref = op(whole, None)
                cot = torch.randn(ref.shape, generator=torch.Generator().manual_seed(height), dtype=torch.float64)
                (ref * cot).sum().backward()
                band = x[:, lo:hi].clone().requires_grad_(True)
                got = op(band, rows)
                olo, ohi = rows.at(ref.shape[1]).span
                (got * cot[:, olo:ohi]).sum().backward()
                err = 0.0 if not got.numel() else float((got - ref[:, olo:ohi]).abs().max())
                if band.numel():
                    err = max(err, float((band.grad - whole.grad[:, lo:hi]).abs().max()))
                if got.shape[1] != ohi - olo:
                    err = float("inf")
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def spatial_dae_step(mesh, device, cfg, jfcn, jdae, images, labels, crop, seed):
    """One DAE train step (gt regime, K1's plain version) H-sharded on
    ('data', 'space') (1, 4) against the same step unsharded: the losses
    and each leaf's Adam first moment (its gradient, scaled)."""
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_dae import StepRandomness, make_dae_train_step

    m = _space_mesh((1, 4))
    tc = TrainConfig()
    rand = StepRandomness(noise_seed=seed, crop=tuple(torch.from_numpy(a) for a in crop), take_gt=True)
    out = {}
    for name, step_mesh in (("unsharded", None), ("sharded", m)):
        dae = params_from_jax(jdae)
        opt = make_optimizer(tc, dae)
        step, eval_step = make_dae_train_step(cfg, tc, opt, h_taps=("pool4",), sigma=0.5, from_gt=True,
                                              dae_depth=4, corruption_impl="kernel", mesh=step_mesh)
        x, y = torch.from_numpy(images), torch.from_numpy(labels)
        if step_mesh is not None:
            x, y = sharding.shard_batch(m, (x, y), spatial_axis="space")
        with contextlib.redirect_stdout(io.StringIO()):
            loss = step(dae, params_from_jax(jfcn), x, y, rand)
            cm, eval_loss = eval_step(dae, params_from_jax(jfcn), x, y, rand)
        out[name] = {"loss": float(loss), "eval_loss": float(eval_loss), "cm": cm.numpy(),
                     "m1": {f"{layer}/{k}": opt.state[t]["exp_avg"].numpy() for layer, v in dae.items()
                            for k, t in v.items()}}
    return out


def spatial_trainer(mesh, device, cfg, jfcn, images, labels):
    """``train_dae`` for one epoch on ('data', 'space') (1, 4), against the
    same trainer unsharded: its history (the bands are put by the
    trainer; the crops are drawn for the whole frame)."""
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_dae import train_dae

    data = [(images, labels)]
    out = {}
    for name, m in (("unsharded", None), ("sharded", _space_mesh((1, 4)))):
        with contextlib.redirect_stdout(io.StringIO()):
            r = train_dae(fcn_params=params_from_jax(jfcn), dataset=cfg, train_data=data, val_data=data,
                          tcfg=TrainConfig(max_epochs=1, seed=3), h_taps=("pool4",), sigma=0.5, from_gt=True,
                          dae_depth=4, dae_widths=(8, 16, 32, 64), corruption_impl="kernel", mesh=m)
        out[name] = r["history"][-1]
    return out


def sharded_restore(mesh, device, jparams, jparams2, workdir):
    """JAX ``tests/test_checkpoint.py:137,162``' twins on ('data',
    'model') (2, 2): a replicated save restored onto the TP layout, and a
    TP-sharded save (the ranks' parts) restored replicated; each leaf's
    part, and the part its placement cuts from the whole leaf."""
    from iterative_inference_segm_tpu_torch.parallel.tp import shard_params_tp, tp_shardings
    from iterative_inference_segm_tpu_torch.utils.checkpoint import restore_checkpoint_sharded, save_checkpoint

    m = make_mesh(("data", "model"), (2, 2))
    params, params2 = params_from_jax(jparams), params_from_jax(jparams2)
    if dist.get_rank() == 0:
        save_checkpoint(f"{workdir}/ck", 3, params)
    dist.barrier()
    shardings = tp_shardings(params, m)
    tp = restore_checkpoint_sharded(f"{workdir}/ck", 3, params, shardings)
    save_checkpoint(f"{workdir}/ck2", 0, shard_params_tp(params2, m), shardings=tp_shardings(params2, m))
    repl = {layer: {k: sharding.replicated_sharding(m) for k in v} for layer, v in params2.items()}
    back = restore_checkpoint_sharded(f"{workdir}/ck2", 0, params2, repl)

    def parts(tree, whole, places):
        return {f"{layer}/{k}": (t.numpy(), places[layer][k].local(whole[layer][k]).numpy(),
                                 tuple(repr(p) for p in places[layer][k].placements))
                for layer, v in tree.items() for k, t in v.items()}

    return {"tp": parts(tp, params, shardings), "replicated": parts(back, params2, repl)}


def dryrun_legs(mesh, device, workdir):
    """``entry.dryrun_multichip``'s legs in this launch's 4 ranks."""
    from iterative_inference_segm_tpu_torch import entry

    with contextlib.redirect_stdout(io.StringIO()):
        return entry._dryrun_legs(mesh, device, dist.get_world_size(), workdir)


def spatial_placements(mesh, device, x):
    """``batch_sharding``/``shard_batch``/``gather_batch`` with
    ``spatial_axis`` on ('data', 'space') (2, 2); the FCN-8 step's refusal
    of a 'space' axis."""
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import make_fcn8_train_step

    m = _space_mesh((2, 2))
    w = {"conv": {"w": torch.zeros(1)}}
    fcn_refusal = raises(lambda: make_fcn8_train_step(CAMVID, TrainConfig(), make_optimizer(TrainConfig(), w), mesh=m))
    t = torch.from_numpy(x)
    place = sharding.batch_sharding(m, 4, spatial_axis="space")
    band = sharding.shard_batch(m, t, spatial_axis="space")
    flat = sharding.shard_batch(m, torch.arange(4.0), spatial_axis="space")
    return {"placements": tuple(repr(p) for p in place.placements), "band": band.numpy(), "flat": flat.numpy(),
            "whole": sharding.gather_batch(m, band, spatial_axis="space").numpy(),
            "coords": (axis_index(m, "data"), axis_index(m, "space")), "fcn_refusal": fcn_refusal}
