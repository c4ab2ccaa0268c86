"""Import reference-era weights (Caffe/Lasagne OIHW layouts) into the port.

The port of ``iterative_inference_segm_tpu.utils.import_weights``. The
numpy converters and the grouping of a positional Lasagne list are copied
in meaning and work on the JAX layout (HWIO conv kernels, the JAX
package's unflipped transposed-conv convention), exactly as in the JAX
package. The entry points take the port's template (OIHW tensors), read its
shapes through ``jax_bridge.params_to_jax``, build the imported tree in the
JAX layout as the JAX package does, and hand it to
``jax_bridge.params_from_jax`` (which owns the deconv flip), on the
template's device and dtype. So an import gives, bit for bit, the port's
image of the JAX import.
"""

from __future__ import annotations

import numpy as np

from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax

# canonical VGG16 conv layer order (matches models/fcn8._VGG)
VGG16_CONV_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
)


def oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """(out, in, kh, kw) -> (kh, kw, in, out)."""
    if w.ndim != 4:
        raise ValueError(f"expected 4-D OIHW weight, got shape {w.shape}")
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def fc_to_conv_hwio(w: np.ndarray, kh: int, kw: int, cin: int) -> np.ndarray:
    """Flat FC matrix (out, cin*kh*kw) in Caffe C,H,W flattening order ->
    (kh, kw, cin, out) conv weight (the fc6-as-conv conversion)."""
    out = w.shape[0]
    if w.ndim != 2 or w.shape[1] != cin * kh * kw:
        raise ValueError(f"expected ({out}, {cin * kh * kw}) FC weight, got {w.shape}")
    w = w.reshape(out, cin, kh, kw)  # O, I, H, W (Caffe flattening)
    return oihw_to_hwio(w)


def fc_to_conv1x1_hwio(w: np.ndarray) -> np.ndarray:
    """Flat FC matrix (out, cin) -> (1, 1, cin, out) conv weight (fc7)."""
    if w.ndim != 2:
        raise ValueError(f"expected 2-D FC weight, got shape {w.shape}")
    return np.ascontiguousarray(w.T[None, None, :, :])


def deconv_iohw_to_hwio(w: np.ndarray, *, flip: bool = False) -> np.ndarray:
    """Reference transposed-conv weight (in, out, kh, kw) -> (kh, kw, in, out),
    the JAX package's layout. ``flip=True`` also reverses the spatial taps,
    for checkpoints saved under the convolution (flipped) convention."""
    if w.ndim != 4:
        raise ValueError(f"expected 4-D IOHW deconv weight, got shape {w.shape}")
    if flip:
        w = w[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


# FCN-8 head layers: name -> kind ('conv' OIHW / 'deconv' IOHW, no bias)
FCN8_HEAD_LAYERS = {
    "score_fr": "conv",
    "score_pool4": "conv",
    "score_pool3": "conv",
    "upscore2": "deconv",
    "upscore_pool4": "deconv",
    "upscore8": "deconv",
}


def _to_port(tree: dict, template: dict) -> dict:
    """A JAX-layout numpy tree -> the port's tensors, on the template's
    device and dtype."""
    leaf = next(iter(next(iter(template.values())).values()))
    return params_from_jax(tree, device=leaf.device, dtype=leaf.dtype)


def _overlay_vgg16(weights: dict, jtree: dict, *, strict: bool) -> dict:
    """``import_vgg16_oihw`` on a JAX-layout numpy tree."""
    out = dict(jtree)
    for name in VGG16_CONV_NAMES:
        if name not in weights:
            if strict:
                raise KeyError(f"missing pretrained layer {name!r}")
            continue
        entry = weights[name]
        w, b = (entry["w"], entry["b"]) if isinstance(entry, dict) else entry
        w = oihw_to_hwio(np.asarray(w))
        b = np.asarray(b)
        if w.shape != tuple(jtree[name]["w"].shape):
            raise ValueError(
                f"{name}: converted shape {w.shape} != model shape {tuple(jtree[name]['w'].shape)}"
            )
        out[name] = {"w": w.astype(np.float32), "b": b.astype(np.float32)}
    return out


def import_vgg16_oihw(weights: dict, params: dict, *, strict: bool = False) -> dict:
    """Overlay OIHW-layout VGG16 conv weights onto the port's FCN-8 tree.

    ``weights`` maps layer name -> {'w': OIHW array, 'b': (out,) array}
    (or tuples). Layers absent from ``weights`` keep their initialization.
    """
    return _to_port(_overlay_vgg16(weights, params_to_jax(params), strict=strict), params)


def _overlay_fcn8(weights: dict, jtree: dict, *, strict: bool, flip_deconvs: bool) -> dict:
    """``import_fcn8_reference`` on a JAX-layout numpy tree."""
    out = _overlay_vgg16(weights, jtree, strict=False)
    missing = [n for n in VGG16_CONV_NAMES if n not in weights]

    def unpack(entry):
        return (entry["w"], entry.get("b")) if isinstance(entry, dict) else (
            entry if isinstance(entry, np.ndarray) else entry[0],
            None if isinstance(entry, np.ndarray) or len(entry) < 2 else entry[1],
        )

    def place(name, w, b):
        tmpl = jtree[name]
        if tuple(w.shape) != tuple(tmpl["w"].shape):
            raise ValueError(
                f"{name}: converted shape {w.shape} != model shape {tuple(tmpl['w'].shape)}"
            )
        new = {"w": np.asarray(w, np.float32)}
        if "b" in tmpl:
            if b is None:
                b = np.zeros(tmpl["b"].shape, np.float32)
            new["b"] = np.asarray(b, np.float32)
        out[name] = new

    for name in ("fc6", "fc7"):
        if name not in weights:
            missing.append(name)
            continue
        w, b = unpack(weights[name])
        w = np.asarray(w)
        if w.ndim == 2:
            if name == "fc6":
                kh, kw, cin, _ = jtree["fc6"]["w"].shape
                w = fc_to_conv_hwio(w, int(kh), int(kw), int(cin))
            else:
                w = fc_to_conv1x1_hwio(w)
        else:
            w = oihw_to_hwio(w)
        place(name, w, b)

    for name, kind in FCN8_HEAD_LAYERS.items():
        if name not in weights:
            missing.append(name)
            continue
        w, b = unpack(weights[name])
        w = np.asarray(w)
        if kind == "deconv":
            w = deconv_iohw_to_hwio(w, flip=flip_deconvs)
        else:
            w = oihw_to_hwio(w)
        place(name, w, b)

    if strict and missing:
        raise KeyError(f"missing pretrained layers: {sorted(missing)}")
    return out


def import_fcn8_reference(
    weights: dict,
    params: dict,
    *,
    strict: bool = False,
    flip_deconvs: bool = False,
) -> dict:
    """Overlay a complete reference-era FCN-8 checkpoint onto the port's
    FCN-8 tree: the VGG stack, ``fc6`` (flat FC or OIHW), ``fc7`` (flat FC or
    OIHW), the 1x1 score convs (OIHW) and the IOHW transposed convs (no
    bias; ``flip_deconvs`` selects the tap convention). Layers absent from
    ``weights`` keep their initialization unless ``strict``."""
    jtree = _overlay_fcn8(weights, params_to_jax(params), strict=strict, flip_deconvs=flip_deconvs)
    return _to_port(jtree, params)


# Canonical FCN-8 layer sequence in the reference's build order (Lasagne's
# ``get_all_param_values`` returns params in build order). Entries: (name,
# kind) with kind in conv/fc/deconv.
FCN8_LASAGNE_ORDER = (
    *((n, "conv") for n in VGG16_CONV_NAMES),
    ("fc6", "fc"),
    ("fc7", "fc"),
    ("score_fr", "conv"),
    ("upscore2", "deconv"),
    ("score_pool4", "conv"),
    ("upscore_pool4", "deconv"),
    ("score_pool3", "conv"),
    ("upscore8", "deconv"),
)


def group_lasagne_arrays(arrays, params: dict) -> dict:
    """Group a positional Lasagne param list into the named-weights dict
    ``import_fcn8_reference`` consumes. ``params`` is a JAX-layout tree
    (HWIO; ``jax_bridge.params_to_jax`` of the port's template) that gives
    the expected shapes.

    Assignment is shape-driven: walk ``FCN8_LASAGNE_ORDER`` and greedily
    consume arrays whose shape matches the expected layer (w in
    OIHW/flat-FC/IOHW form, optionally followed by its (out,) bias; deconvs
    carry no bias). Layers the checkpoint lacks are skipped; equal-shape
    layers resolve by order.
    """
    arrays = [np.asarray(a) for a in arrays]
    out: dict = {}
    i = 0

    def expected_w_shapes(name: str, kind: str) -> list[tuple[int, ...]]:
        kh, kw, cin, cout = (int(d) for d in params[name]["w"].shape)
        if kind == "conv":
            return [(cout, cin, kh, kw)]
        if kind == "fc":
            # flat FC or already-converted conv form
            return [(cout, cin * kh * kw), (cout, cin, kh, kw)]
        return [(cin, cout, kh, kw)]  # deconv IOHW

    for name, kind in FCN8_LASAGNE_ORDER:
        if i >= len(arrays):
            break
        shapes = expected_w_shapes(name, kind)
        if tuple(arrays[i].shape) not in shapes:
            continue  # layer absent from this checkpoint
        w = arrays[i]
        i += 1
        entry = {"w": w}
        if kind != "deconv":
            cout = int(params[name]["w"].shape[3])
            if i < len(arrays) and arrays[i].shape == (cout,):
                entry["b"] = arrays[i]
                i += 1
        out[name] = entry
    if i != len(arrays):
        raise ValueError(
            f"could not place {len(arrays) - i} trailing arrays "
            f"(next shape {arrays[i].shape}); checkpoint order does not match "
            "the FCN-8 build sequence"
        )
    return out


def _positional(path) -> list[np.ndarray]:
    """The arrays of an ``np.savez(*arrays)`` file in their order (keys
    arr_0..arr_N, sorted numerically)."""
    with np.load(path) as data:
        keys = sorted(
            data.files,
            key=lambda k: int(k.split("_")[-1]) if k.split("_")[-1].isdigit() else 10**9,
        )
        return [data[k] for k in keys]


def import_lasagne_npz(path, params: dict, *, strict: bool = False, flip_deconvs: bool = False) -> dict:
    """Load a reference-era positional ``.npz`` (np.savez of
    ``get_all_param_values``) straight into the port's FCN-8 tree."""
    jtree = params_to_jax(params)
    named = group_lasagne_arrays(_positional(path), jtree)
    return _to_port(_overlay_fcn8(named, jtree, strict=strict, flip_deconvs=flip_deconvs), params)


def group_mirror_dae_arrays(arrays, params: dict) -> dict:
    """Group a positional Lasagne param list into a mirror-DAE overlay
    (JAX layout: HWIO kernels). ``params`` is a JAX-layout mirror tree.

    Assumed build order (the reference's ``buildDAE``):

        enc1.W (OIHW), enc1.b, ..., encD.W, encD.b,        # encoder, shallow->deep
        decD.[W,] decD.b, ..., dec1.[W,] dec1.b,           # decoder, deep->shallow
        out.W, out.b                                       # 1x1 head

    Tied checkpoints carry decoder biases only; whether the checkpoint is
    tied is read from the template (``models.dae_mirror.mirror_tied_of``).
    """
    from iterative_inference_segm_tpu_torch.models.dae_mirror import mirror_depth_of, mirror_tied_of

    arrays = [np.asarray(a) for a in arrays]
    depth = mirror_depth_of(params)
    tied = mirror_tied_of(params)

    order: list[tuple[str, bool]] = []  # (layer name, has kernel)
    order += [(f"enc{i + 1}", True) for i in range(depth)]
    if "mid" in params:  # bottleneck conditioning conv (untied, built after the encoder)
        order += [("mid", True)]
    order += [(f"dec{i + 1}", not tied) for i in reversed(range(depth))]
    order += [("out", True)]

    out: dict = {}
    i = 0
    for name, has_w in order:
        entry = {}
        tmpl = params[name]
        if has_w:
            kh, kw, cin, cout = (int(d) for d in tmpl["w"].shape)
            want = (cout, cin, kh, kw)
            if i >= len(arrays) or tuple(arrays[i].shape) != want:
                got = tuple(arrays[i].shape) if i < len(arrays) else "end-of-list"
                raise ValueError(
                    f"mirror-DAE import: {name}.W expected OIHW {want}, got {got} "
                    f"at position {i} — checkpoint order does not match the "
                    "assumed buildDAE sequence (see group_mirror_dae_arrays)"
                )
            entry["w"] = oihw_to_hwio(arrays[i])
            i += 1
        bshape = tuple(int(d) for d in tmpl["b"].shape)
        if i >= len(arrays) or tuple(arrays[i].shape) != bshape:
            got = tuple(arrays[i].shape) if i < len(arrays) else "end-of-list"
            raise ValueError(
                f"mirror-DAE import: {name}.b expected {bshape}, got {got}"
            )
        entry["b"] = arrays[i]
        i += 1
        out[name] = entry
    if i != len(arrays):
        raise ValueError(
            f"mirror-DAE import: {len(arrays) - i} trailing arrays left over "
            f"(next shape {arrays[i].shape}) — checkpoint does not match the "
            f"{'tied' if tied else 'untied'} depth-{depth} template"
        )
    return out


def import_mirror_dae_npz(path, params: dict) -> dict:
    """Load a reference-era positional mirror-DAE ``.npz`` into the port's
    mirror-DAE tree (layout conversion automatic). The template's tied or
    untied structure selects which checkpoint format is expected."""
    jtree = params_to_jax(params)
    named = group_mirror_dae_arrays(_positional(path), jtree)
    out = dict(jtree)
    for name, entry in named.items():
        tmpl = jtree[name]
        new = {"b": np.asarray(entry["b"], np.float32)}
        if "w" in entry:
            if tuple(entry["w"].shape) != tuple(tmpl["w"].shape):
                raise ValueError(
                    f"{name}: converted shape {entry['w'].shape} != model shape "
                    f"{tuple(tmpl['w'].shape)}"
                )
            new["w"] = np.asarray(entry["w"], np.float32)
        out[name] = new
    return _to_port(out, params)
