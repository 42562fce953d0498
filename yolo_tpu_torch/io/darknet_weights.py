"""Darknet ``.weights`` binary I/O for the port's layer set (port of
yolo_tpu/io/darknet_weights.py: convs, connected and local layers and
weighted shortcuts; the port's other layers carry no weights).

File format (darknet ``parse.c`` save/load order):
  header: int32 major, minor, revision; then ``seen`` — int64 if
  major*10+minor >= 2 (20-byte header), else int32 (16 bytes).
  per conv layer, in cfg order:
    biases[oc]                       (BN beta when bn=True)
    if bn: scales[oc] (gamma), rolling_mean[oc], rolling_var[oc]
    kernel fp32, darknet (oc, ic/groups, kh, kw) order -> HWIO here.
  per connected layer (save_connected_weights):
    biases[out], weights[out*in] row-major (out, in) -> (in, out) here.
  per weighted shortcut (save_shortcut_weights): its blend weights,
    2 floats (per_feature) or 2*C (per_channel), group major.
  per local layer (the yolov1 head, specs.Local): biases[out_h*out_w*
    filters] in CHW order, then one (filters, in_c, k, k) block a
    position, positions row-major.

Params list, ordered like ``weighted_specs(layers)``:
  [{"kernel": HWIO f32, "bias": (oc,)}                     bn=False convs,
   {"kernel": HWIO f32, "gamma","beta","mean","var": (oc,)} bn=True convs,
   {"kernel": (in, out) f32, "bias": (out,)}           connected layers,
   {"kernel": (H', W', F, C, k, k) f32, "bias": (H', W', F)}  local layers,
   {"weights": (2, 1) or (2, C) f32}                  weighted shortcuts]
the JAX package's layout, byte for byte the same files.
"""

from __future__ import annotations

import io as _io
from typing import BinaryIO, List, Optional, Sequence

import numpy as np

from yolo_tpu_torch.configs.specs import (Connected, Conv, LayerSpec, Local,
                                          Reorg, Route, ScaleChannels,
                                          Shortcut, YoloHead, resolve_route,
                                          weighted_specs)


def _conv_in_channels(layers: Sequence[LayerSpec],
                      input_channels: int = 3) -> List[int]:
    """Input channel count of each weighted layer (darknet_weights.py::
    _infer_in_channels), walking the layer graph: a grouped route keeps
    1/groups of each source, scale_channels takes its ``frm`` layer's
    count; a local layer's output has its filters; the weightless rest
    keep the count. A weighted shortcut's entry is its own channel count
    (its per_channel weight count); a connected layer's its input
    features (in_features for a spatial input, else the channels)."""
    out_ch: List[int] = []
    conv_in: List[int] = []
    prev = input_channels
    for idx, layer in enumerate(layers):
        if isinstance(layer, Conv):
            conv_in.append(prev)
            prev = layer.filters
        elif isinstance(layer, Reorg):
            prev = prev * layer.stride * layer.stride
        elif isinstance(layer, Route):
            prev = sum(out_ch[resolve_route(idx, r)] // layer.groups
                       for r in layer.layers)
        elif isinstance(layer, ScaleChannels):
            prev = out_ch[resolve_route(idx, layer.frm)]
        elif isinstance(layer, Connected):
            conv_in.append(layer.in_features
                           if layer.in_features is not None else prev)
            prev = layer.out
        elif isinstance(layer, Local):
            conv_in.append(prev)
            prev = layer.filters
        elif isinstance(layer, Shortcut) and layer.weights_type != "none":
            conv_in.append(prev)
        out_ch.append(prev)
    return conv_in


def _floats(spec, ic: int) -> int:
    """Floats a weighted layer holds in the file, its input channels
    ``ic``."""
    if isinstance(spec, Shortcut):
        return 2 * (1 if spec.weights_type == "per_feature" else ic)
    if isinstance(spec, Connected):
        return spec.out + spec.out * ic
    if isinstance(spec, Local):
        loc = spec.out_h * spec.out_w
        return spec.filters * loc * (1 + spec.in_c * spec.size * spec.size)
    return (spec.filters * (4 if spec.bn else 1)
            + spec.filters * (ic // spec.groups) * spec.size * spec.size)


def expected_bytes(layers: Sequence[LayerSpec], input_channels: int = 3
                   ) -> int:
    """Exact .weights file size for a topology, with the 20-byte header
    (zoo.py::expected_weights_bytes)."""
    n = sum(_floats(spec, ic)
            for spec, ic in zip(weighted_specs(tuple(layers)),
                                _conv_in_channels(layers, input_channels)))
    return 20 + 4 * n


def _groups_divide(conv: Conv, ic: int, i: int) -> None:
    if conv.filters % conv.groups or ic % conv.groups:
        raise ValueError(
            f"conv {i}: groups={conv.groups} must divide "
            f"filters={conv.filters} and in_channels={ic}")


def load(path_or_file, layers: Sequence[LayerSpec], input_channels: int = 3):
    """Load a darknet .weights file into a params list for ``layers``.
    The file must hold every conv and end exactly after the last one;
    partial backbone files go through load_partial. Returns (params,
    header)."""
    params, header, n = load_partial(path_or_file, layers,
                                     input_channels=input_channels)
    total = len(weighted_specs(tuple(layers)))
    if n != total:
        raise ValueError(
            f"weights file too short: only {n} of {total} weighted "
            f"layers present (partial backbone file? use load_partial)")
    return params, header


def load_partial(path_or_file, layers: Sequence[LayerSpec],
                 input_channels: int = 3):
    """Load a possibly truncated darknet .weights file, darknet's
    ``partial`` output (e.g. ``darknet19_448.conv.23``, the backbone that
    YOLOv2 fine-tuning starts from). Returns (params_prefix, header,
    n_convs_loaded). The file must end exactly at a conv boundary, as
    darknet's cutoffs do; anything else raises. A full file loads every
    conv, as load does."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    if len(data) < 16:
        raise ValueError(f"weights file too short ({len(data)} bytes "
                         f"— no header)")
    major, minor, revision = np.frombuffer(data, np.int32, 3)
    if major > 1000 or minor > 1000:
        # parse.c: versions > 1000 flag the old transposed format
        raise ValueError(
            f"weights header major={major} minor={minor}: the "
            f"pre-2016 transposed format is not supported")
    if major * 10 + minor >= 2:
        seen = int(np.frombuffer(data, np.int64, 1, 12)[0])
        offset = 20
    else:
        seen = int(np.frombuffer(data, np.int32, 1, 12)[0])
        offset = 16
    if (len(data) - offset) % 4:
        raise ValueError("weights file truncated mid-float "
                         f"({len(data) - offset} payload bytes)")
    floats = np.frombuffer(data, np.float32, offset=offset)

    pos = 0
    params = []
    for spec, ic in zip(weighted_specs(tuple(layers)),
                        _conv_in_channels(layers, input_channels)):
        if isinstance(spec, Shortcut):
            # weighted shortcut: its blend weights, group major
            per = 1 if spec.weights_type == "per_feature" else ic
            need = 2 * per
            if pos == floats.size:
                break  # clean cutoff boundary
            if pos + need > floats.size:
                raise ValueError(
                    f"weights file too short (ends mid-layer): "
                    f"weighted shortcut {len(params)} needs {need} "
                    f"floats, {floats.size - pos} remain")
            params.append({"weights": floats[pos:pos + need]
                           .reshape(2, per).copy()})
            pos += need
            continue
        if isinstance(spec, Connected):
            oc = spec.out
            need = oc + oc * ic
            if pos == floats.size:
                break  # clean cutoff boundary
            if pos + need > floats.size:
                raise ValueError(
                    f"weights file too short (ends mid-layer): "
                    f"connected {len(params)} needs {need} floats, "
                    f"{floats.size - pos} remain")
            bias = floats[pos:pos + oc].copy()
            w = floats[pos + oc:pos + need].reshape(oc, ic)
            params.append({"bias": bias, "kernel": np.ascontiguousarray(w.T)})
            pos += need
            continue
        if isinstance(spec, Local):
            hh, ww, oc, k = spec.out_h, spec.out_w, spec.filters, spec.size
            if not (hh and ww and spec.in_c):
                raise ValueError(
                    f"local layer {len(params)} has unpinned geometry "
                    f"(out_h/out_w/in_c) — build configs through the "
                    f"cfg parser, which sizes [local] from the input")
            need = _floats(spec, ic)
            if pos == floats.size:
                break  # clean cutoff boundary
            if pos + need > floats.size:
                raise ValueError(
                    f"weights file too short (ends mid-layer): local "
                    f"{len(params)} needs {need} floats, "
                    f"{floats.size - pos} remain")
            nb = oc * hh * ww
            bias = floats[pos:pos + nb].reshape(oc, hh, ww)
            w = floats[pos + nb:pos + need].reshape(hh, ww, oc, spec.in_c,
                                                    k, k)
            params.append({"bias": np.ascontiguousarray(
                               bias.transpose(1, 2, 0)),
                           "kernel": w.copy()})
            pos += need
            continue
        conv = spec
        _groups_divide(conv, ic, len(params))
        ic = ic // conv.groups  # darknet grouped kernel: (oc, ic/g, k, k)
        oc, k = conv.filters, conv.size
        need = oc * (4 if conv.bn else 1) + oc * ic * k * k
        if pos == floats.size:
            break  # clean cutoff boundary
        if pos + need > floats.size:
            raise ValueError(
                f"weights file too short (ends mid-layer): conv "
                f"{len(params)} needs {need} floats, "
                f"{floats.size - pos} remain")
        p = {}
        if conv.bn:
            for key in ("beta", "gamma", "mean", "var"):
                p[key] = floats[pos:pos + oc].copy()
                pos += oc
        else:
            p["bias"] = floats[pos:pos + oc].copy()
            pos += oc
        kern = floats[pos:pos + oc * ic * k * k].reshape(oc, ic, k, k)
        pos += oc * ic * k * k
        p["kernel"] = np.ascontiguousarray(kern.transpose(2, 3, 1, 0))
        params.append(p)
    if pos != floats.size:
        raise ValueError(
            f"weights file not fully consumed: read {pos} of "
            f"{floats.size} floats — layer spec does not match file")
    header = {"major": int(major), "minor": int(minor),
              "revision": int(revision), "seen": seen}
    return params, header, len(params)


def save(path_or_file, layers: Sequence[LayerSpec], params, seen: int = 0,
         version=(0, 2, 0), cutoff_convs: Optional[int] = None) -> None:
    """Write params out in darknet format (HWIO -> OIHW).
    ``cutoff_convs`` writes only the first N weighted layers (darknet's
    ``partial``: a backbone file)."""
    specs = weighted_specs(tuple(layers))
    if cutoff_convs is not None:
        specs, params = specs[:cutoff_convs], params[:cutoff_convs]
    elif len(params) != len(specs):
        raise ValueError(f"save: {len(params)} param blocks for "
                         f"{len(specs)} weighted layers (use cutoff_convs "
                         f"for partials)")
    own = not hasattr(path_or_file, "write")
    f: BinaryIO = open(path_or_file, "wb") if own else path_or_file
    try:
        major, minor, revision = version
        f.write(np.asarray([major, minor, revision], np.int32).tobytes())
        seen_dtype = np.int64 if major * 10 + minor >= 2 else np.int32
        f.write(np.asarray([seen], seen_dtype).tobytes())
        for conv, p in zip(specs, params):
            if isinstance(conv, Shortcut):
                f.write(np.ascontiguousarray(
                    np.asarray(p["weights"], np.float32)).tobytes())
                continue
            if isinstance(conv, Connected):
                f.write(np.asarray(p["bias"], np.float32).tobytes())
                f.write(np.ascontiguousarray(
                    np.asarray(p["kernel"], np.float32).T).tobytes())
                continue
            if isinstance(conv, Local):
                # (H', W', F) biases in CHW order, then the
                # location-major kernel as it is held
                f.write(np.ascontiguousarray(np.asarray(
                    p["bias"], np.float32).transpose(2, 0, 1)).tobytes())
                f.write(np.ascontiguousarray(
                    np.asarray(p["kernel"], np.float32)).tobytes())
                continue
            keys = ("beta", "gamma", "mean", "var") if conv.bn else ("bias",)
            for key in keys:
                f.write(np.asarray(p[key], np.float32).tobytes())
            kernel = np.asarray(p["kernel"], np.float32)
            f.write(np.ascontiguousarray(
                kernel.transpose(3, 2, 0, 1)).tobytes())
    finally:
        if own:
            f.close()


def random_params(layers: Sequence[LayerSpec], rng: np.random.Generator,
                  input_channels: int = 3, scale: float = 0.1):
    """Random params in load()'s layout, drawn in the JAX package's order
    (the same generator state gives the same params there). Shortcut
    blend weights are darknet's initial ones and draw nothing."""
    params = []
    for conv, ic in zip(weighted_specs(tuple(layers)),
                        _conv_in_channels(layers, input_channels)):
        if isinstance(conv, Shortcut):
            per = 1 if conv.weights_type == "per_feature" else ic
            params.append({"weights": np.ones((2, per), np.float32)})
            continue
        if isinstance(conv, Connected):
            params.append({
                "kernel": rng.normal(0, scale,
                                     (ic, conv.out)).astype(np.float32),
                "bias": rng.normal(0, 0.1, conv.out).astype(np.float32)})
            continue
        if isinstance(conv, Local):
            hwf = (conv.out_h, conv.out_w, conv.filters)
            params.append({
                "kernel": rng.normal(0, scale, hwf + (
                    conv.in_c, conv.size, conv.size)).astype(np.float32),
                "bias": rng.normal(0, 0.1, hwf).astype(np.float32)})
            continue
        _groups_divide(conv, ic, len(params))
        ic = ic // conv.groups
        oc, k = conv.filters, conv.size
        p = {"kernel": rng.normal(0, scale, (k, k, ic, oc)).astype(np.float32)}
        if conv.bn:
            p["gamma"] = rng.uniform(0.5, 1.5, oc).astype(np.float32)
            p["beta"] = rng.normal(0, 0.1, oc).astype(np.float32)
            p["mean"] = rng.normal(0, 0.1, oc).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, oc).astype(np.float32)
        else:
            p["bias"] = rng.normal(0, 0.1, oc).astype(np.float32)
        params.append(p)
    return params


def to_bytes(layers: Sequence[LayerSpec], params, seen: int = 0,
             version=(0, 2, 0)) -> bytes:
    """save's bytes, in memory."""
    bio = _io.BytesIO()
    save(bio, layers, params, seen=seen, version=version)
    return bio.getvalue()


# seeded weights: the residual branches' last convs are scaled by this
RESIDUAL_SCALE = 0.1
# seeded [yolo] heads, calibrated on the probe: this many boxes of the
# probe image reach objectness logit SURE_LOGIT (sigmoid 0.88) and four
# times as many 0 (sigmoid 0.5); one class logit in C reaches SURE_LOGIT
# and three in C reach 0
PROBE_OBJECTS, SURE_LOGIT = 8, 2.0
# seeded [Gaussian_yolo] heads: the sigma logits sit near this, so that
# 1 - mean(sigma) (sigmoid(-4) = 0.018) leaves the scores nearly whole
SIGMA_LOGIT = -4.0
# seeded yolov1 [detection] heads: on the probe, each block of the flat
# head (class probabilities, confidences, box x, y, sqrt w, sqrt h) gets
# this (mean, spread) across its values; confidence x probability then
# clears 0.2 for a few percent of the (box, class) pairs, and boxes are
# about a tenth of the image wide
DETECTION_BLOCKS = {"probs": (0.2, 0.15), "conf": (0.3, 0.2),
                    "xy": (0.5, 0.2), "wh": (0.3, 0.05)}


def _param_index(layers) -> dict:
    """{layer index: params index} of the weighted layers."""
    out = {}
    for idx, layer in enumerate(layers):
        if isinstance(layer, (Conv, Connected, Local)) or (
                isinstance(layer, Shortcut)
                and layer.weights_type != "none"):
            out[idx] = len(out)
    return out


def _probe_head_outputs(cfg, params, seed: int):
    """Each [yolo] head conv's output before its bias and activation,
    (positions, C) float64, from one fp32 forward of the port's executor
    on the CPU over a seeded probe at the config's (net_h, net_w): the
    letterbox of a 3:4 uniform-noise frame (gray 0.5 bands, as a 480x640
    frame gives them). A logistic head conv (new_coords) runs linear
    here, so the calibration acts before its logistic."""
    import dataclasses

    import torch

    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.ops.letterbox import letterbox_geometry

    heads = [i - 1 for i, l in enumerate(cfg.layers)
             if isinstance(l, YoloHead)]
    layers = tuple(dataclasses.replace(l, act="linear") if i in heads
                   else l for i, l in enumerate(cfg.layers))
    folded = fold_params(layers, params, cfg.bn_eps)
    h, w = cfg.input_hw
    _, rh, rw, px, py = letterbox_geometry(480, 640, (h, w))
    x = np.full((1, h, w, cfg.in_channels), 0.5, np.float32)
    x[:, py:py + rh, px:px + rw] = np.random.default_rng(
        (seed, h) if h == w else (seed, h, w)).uniform(
            0, 1, (1, rh, rw, cfg.in_channels))
    out = Darknet(layers, folded, device="cpu")(torch.from_numpy(x))
    index = _param_index(layers)
    return [o.numpy().reshape(-1, o.shape[-1]).astype(np.float64)
            - folded[index[i]]["bias"] for o, i in zip(out, heads,
                                                       strict=True)]


def _calibrate_detection_head(cfg, params, seed: int) -> None:
    """yolov1 head shaping, in place: the last [connected] layer's
    outputs are made affine in z, their zero-mean unit-spread value
    across each block of the flat [detection] layout on a seeded probe,
    with the block's DETECTION_BLOCKS (mean, spread). The probe is one
    fp32 forward of the port's executor on the CPU up to the connected
    layer, on the letterbox of a seeded 480x640 uint8 noise frame (what
    a served frame of that kind gives the net)."""
    import torch

    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.ops.letterbox import letterbox

    head = cfg.detection_head
    trunk = cfg.layers[:-2]            # up to the [connected] head
    folded = fold_params(trunk, params[:-1], cfg.bn_eps)
    frame = np.random.default_rng((seed, cfg.input_h)).integers(
        0, 256, (1, 480, 640, cfg.in_channels), dtype=np.uint8)
    x = letterbox(torch.from_numpy(frame), cfg.input_hw)
    feats = Darknet(trunk, folded, device="cpu")(x)
    feats = feats.numpy().transpose(0, 3, 1, 2).reshape(-1)  # CHW order
    p = params[-1]
    v = feats.astype(np.float64) @ p["kernel"].astype(np.float64)
    s2, n, c = head.side ** 2, head.num, head.classes
    blocks = np.empty(v.size, object)
    blocks[:s2 * c] = "probs"
    blocks[s2 * c:s2 * (c + n)] = "conf"
    coords = np.arange(v.size - s2 * (c + n)) % head.coords
    blocks[s2 * (c + n):] = np.where(coords < 2, "xy", "wh")
    gain, shift = np.empty(v.size), np.empty(v.size)
    for name, (mean, spread) in DETECTION_BLOCKS.items():
        sel = blocks == name
        m, sd = v[sel].mean(), v[sel].std()
        gain[sel] = spread / sd
        shift[sel] = mean - m * spread / sd
    p["kernel"] = (p["kernel"] * gain).astype(np.float32)
    p["bias"] = shift.astype(np.float32)


def _calibrate_yolo_heads(cfg, params, heads, seed: int,
                          box_scale: float) -> None:
    """[yolo] head shaping, in place: each head conv's channels are
    made affine in z, their zero-mean unit-spread value on the probe
    (before the activation): box channels box_scale * z; objectness and
    class logits SURE_LOGIT * (z - t0) / (t1 - t0), t1 and t0 the
    quantiles of z that PROBE_OBJECTS and 4 * PROBE_OBJECTS probe boxes
    reach (classes: 1/C and 3/C of the class logits); a Gaussian head's
    sigma logits SIGMA_LOGIT + box_scale * z. heads: (params index,
    anchors, gaussian) of each head conv."""
    c = cfg.num_classes
    z, norm = [], []
    for (i, a, ga), v in zip(heads, _probe_head_outputs(cfg, params, seed),
                             strict=True):
        mean, std = v.mean(axis=0), v.std(axis=0)
        zz = ((v - mean) / std).reshape(-1, a, (9 if ga else 5) + c)
        z.append(zz[..., 4 + 4 * ga:])     # objectness, then classes
        norm.append((mean, std))
    obj = np.sort(np.concatenate([h[..., 0].ravel() for h in z]))
    cls = np.concatenate([h[..., 1:].ravel() for h in z])
    # (gain, offset) of the objectness and class logits in z
    spans = [(obj[-PROBE_OBJECTS], obj[-4 * PROBE_OBJECTS]),
             tuple(np.quantile(cls, [1.0 - 1.0 / c, 1.0 - 3.0 / c]))]
    (g_obj, t_obj), (g_cls, t_cls) = [
        (SURE_LOGIT / (hi - lo), lo) for hi, lo in spans]
    for (i, a, ga), (mean, std) in zip(heads, norm):
        o = 4 + 4 * ga                     # objectness channel
        gain = np.ones((a, o + 1 + c))
        gain[:, :o], gain[:, o], gain[:, o + 1:] = box_scale, g_obj, g_cls
        shift = np.zeros((a, o + 1 + c))
        shift[:, o], shift[:, o + 1:] = -g_obj * t_obj, -g_cls * t_cls
        if ga:
            shift[:, 1:8:2] = SIGMA_LOGIT
        gain, shift = gain.reshape(-1), shift.reshape(-1)
        p = params[i]
        p["kernel"] = (p["kernel"] * (gain / std)).astype(np.float32)
        p["bias"] = (-mean / std * gain + shift).astype(np.float32)


def synthetic_detector_params(cfg, seed: int, *, box_scale: float = 0.1,
                              objectness_shift: float = -2.0):
    """Seeded random weights for a detector, for runs without trained
    weights.

    random_params' std 0.1 at every layer overflows exp(tw) on yolov2
    (mean |logit| ~1e9), so kernels are rescaled to He's std
    sqrt(2/fan_in) and logits are O(1). The head conv's box channels are
    then scaled by ``box_scale``, so boxes stay near their anchors' size
    instead of covering the image or collapsing to zero width. For the
    region head, the objectness biases are shifted by
    ``objectness_shift``, so that, as in a trained detector, most cells
    hold no object; box_scale=1 and objectness_shift=0 give plain He
    weights.

    A residual add (Shortcut) sums branch and trunk, so at plain He
    scale the trunk's variance doubles with every block, and yolov3's 23
    blocks take the logits to ~1e3 and exp(tw) past fp32's range; the
    last conv of each residual branch is scaled by RESIDUAL_SCALE, which
    keeps every head's mean |logit| O(1). The deep [yolo] nets still end
    with an objectness spread of 2-8 that differs by variant and input
    size (the folded BN scale and mish raise the second moment layer by
    layer), so a fixed shift would put a third of their boxes above
    objectness 0.5, or none. Their heads are calibrated on a seeded
    probe frame instead (_calibrate_yolo_heads, which ignores
    objectness_shift): on noise frames of the probe's kind a few dozen
    boxes an image clear objectness 0.5, far fewer than the fused head's
    prefilter keeps, and the detectors keep 10-100 detections an image
    at conf 0.5. A logistic head conv (new_coords) is calibrated before
    its logistic, and a Gaussian head's sigma logits sit near
    SIGMA_LOGIT; shortcut blend weights stay darknet's ones. A
    classifier (a connected kernel's fan-in is its input features) keeps
    the He weights as they are. A yolov1 [detection] head, whose flat
    values are used without an activation, is shaped on the probe block
    by block (_calibrate_detection_head)."""
    params = random_params(cfg.layers, np.random.default_rng(seed),
                           input_channels=cfg.in_channels)
    for p in params:
        if "kernel" not in p:
            continue                       # shortcut blend weights
        k = p["kernel"]
        # fan-in: HWI of a conv, in of a connected layer, (C, k, k) of
        # a local layer's (H', W', F, C, k, k)
        fan_in = np.prod(k.shape[3:] if k.ndim == 6 else k.shape[:-1])
        p["kernel"] = (k * (np.sqrt(2.0 / fan_in) / 0.1)).astype(np.float32)
    index = _param_index(cfg.layers)
    for idx, layer in enumerate(cfg.layers):
        if isinstance(layer, Shortcut) and isinstance(
                cfg.layers[idx - 1] if idx else None, Conv):
            params[index[idx - 1]]["kernel"] *= np.float32(RESIDUAL_SCALE)
    if cfg.head_kind == "softmax":
        return params                      # a classifier: He weights
    if cfg.head_kind == "detection":
        _calibrate_detection_head(cfg, params, seed)
        return params
    if cfg.head_kind == "yolo":
        _calibrate_yolo_heads(cfg, params, [
            (index[idx - 1], len(layer.mask), layer.gaussian)
            for idx, layer in enumerate(cfg.layers)
            if isinstance(layer, YoloHead)], seed, box_scale)
        return params
    c, a = cfg.num_classes, cfg.num_anchors
    params[-1]["kernel"].reshape(-1, a, 5 + c)[..., :4] *= box_scale
    params[-1]["bias"].reshape(a, 5 + c)[:, 4] += objectness_shift
    return params
