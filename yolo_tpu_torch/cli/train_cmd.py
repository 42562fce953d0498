"""`train`: detector fine-tuning with the region (YOLO9000 trees too) or
[yolo] loss, and classifier training on an imagefolder
(train_helpers._train_classifier) (port of yolo_tpu/cli/train_cmd.py),
data-parallel over this process's cards (parallel/sharding.py; one card
steps as train.loop.make_train_step does).

Checkpoints (--checkpoint-dir: step_N every --checkpoint-every steps,
best on a better --eval-every mAP, final at the end) are written by
io.checkpoint.AsyncSaver. --resume restores the model, optimizer, step
and seen counters. The threads loader then runs --epochs epochs of the
data from the first; --loader grain (data/grain_pipeline.py) spans all
epochs in one iterator whose position is written beside each checkpoint
(<checkpoint>.grain) and restored with it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from yolo_tpu_torch.cli._common import (_compute_dtype, _dataset_samples,
                                        _device, _get_cfg, _resolve_weights)
from yolo_tpu_torch.cli.train_helpers import (_batch_accum_from,
                                              _lr_schedule_from, _net_size,
                                              _optimizer_from,
                                              _restore_adapt_ema,
                                              _train_classifier,
                                              _train_mesh)


def _fmt_sizes(sizes) -> str:
    """Human form of a multi-scale ladder: WxH for rect buckets."""
    return ",".join(f"{s[1]}x{s[0]}" if isinstance(s, tuple) else str(s)
                    for s in sizes)


def _parse_multi_scale_sizes(spec: str, cfg):
    """--multi-scale-sizes tokens: square ints or WIDTHxHEIGHT pairs
    (rectangular buckets); a bare int on a rectangular net is refused
    (it would square the cfg's aspect), and every dimension must be a
    multiple of 32."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        try:
            if "x" in tok.lower():
                w_s, h_s = tok.lower().split("x", 1)
                hw = (int(h_s), int(w_s))  # internal (net_h, net_w)
            else:
                if cfg.input_w != cfg.input_h:
                    raise SystemExit(
                        f"--multi-scale-sizes entry '{tok}' is a "
                        f"SQUARE bucket but {cfg.name} is rectangular "
                        f"({cfg.input_w}x{cfg.input_h}) — write rect "
                        f"buckets as WIDTHxHEIGHT (e.g. "
                        f"{cfg.input_w}x{cfg.input_h})")
                hw = int(tok)
        except ValueError:
            raise SystemExit(f"--multi-scale-sizes entry '{tok}': "
                             f"expected an int or WIDTHxHEIGHT") from None
        dims = (hw,) if isinstance(hw, int) else hw
        if any(d < 32 or d % 32 for d in dims):
            raise SystemExit(f"--multi-scale-sizes entry '{tok}': "
                             f"sizes must be multiples of 32")
        out.append(hw)
    return tuple(out)


def _multi_scale(args, cfg, net_hp):
    """The multi-scale ladder (None: the default ladder or none) after
    --multi-scale, --multi-scale-sizes and the cfg's random= key, which
    turns multi-scale on as darknet's does; sets args.multi_scale."""
    from yolo_tpu_torch.train.loop import proportional_sizes

    if (args.multi_scale_every is not None
            and args.multi_scale_every < 1):
        raise SystemExit(f"--multi-scale-every must be >= 1, got "
                         f"{args.multi_scale_every}")
    sizes = (_parse_multi_scale_sizes(args.multi_scale_sizes, cfg)
             if args.multi_scale_sizes else None)
    if (cfg.input_w != cfg.input_h and args.multi_scale
            and sizes is None):
        # rectangular nets: aspect-preserving buckets (AlexeyAB resizes
        # both dims by one factor, default coef 1.4)
        sizes = proportional_sizes(cfg.input_h, cfg.input_w)
        print(f"rectangular net: multi-scale uses aspect-preserving "
              f"buckets {_fmt_sizes(sizes)} (every 10 batches)",
              file=sys.stderr)
    if not args.multi_scale and net_hp.get("random", 0) > 0:
        # the head sections' random=1 is darknet's multi-scale switch
        args.multi_scale = True
        rf = float(net_hp["random"])
        if cfg.input_w != cfg.input_h:
            if sizes is None:
                coef = rf if rf > 1.0 else 1.4
                sizes = proportional_sizes(cfg.input_h, cfg.input_w, coef)
                print(f"cfg random={rf:g}: aspect-preserving "
                      f"multi-scale buckets {_fmt_sizes(sizes)} "
                      f"(both dims x [1/{coef:g}, {coef:g}], every "
                      f"10 batches)", file=sys.stderr)
        elif rf > 1.0 and sizes is None:
            # AlexeyAB fractional random (e.g. 1.3): [net/f, net*f],
            # snapped to multiples of 32
            base = cfg.input_size
            lo = max(32, int(round(base / rf / 32)) * 32)
            hi = int(round(base * rf / 32)) * 32
            sizes = tuple(range(lo, hi + 1, 32))
            print(f"cfg random={rf:g}: multi-scale range "
                  f"{lo}..{hi} (net/{rf:g} .. net*{rf:g}, "
                  f"every 10 batches)", file=sys.stderr)
        else:
            print("cfg random=1: multi-scale training enabled "
                  "(darknet 320..608 every 10 batches)", file=sys.stderr)
    if not args.multi_scale and (args.multi_scale_sizes
                                 or args.multi_scale_every is not None):
        raise SystemExit(
            "--multi-scale-sizes/--multi-scale-every have no effect "
            "without --multi-scale (or a cfg with random=1) — add "
            "--multi-scale or drop the flags")
    return sizes


_AUG_KEYS = ("jitter", "saturation", "exposure", "hue", "flip",
             "mosaic", "mixup", "blur", "gaussian_noise")


def _augment_config(args, net_hp):
    """Darknet augments whenever the cfg writes an augmentation key;
    --augment turns the classic defaults on, --no-augment turns all
    off, --mosaic / --mixup force those modes on. Mosaic and mixup
    together are refused."""
    from yolo_tpu_torch.data.augment import config_from_net_params

    cfg_wants_aug = any(k in net_hp for k in _AUG_KEYS)
    if not (args.augment or args.mosaic or args.mixup or cfg_wants_aug) \
            or args.no_augment:
        return None
    aug_cfg = config_from_net_params(net_hp, mosaic=args.mosaic,
                                     mixup=args.mixup,
                                     force_defaults=not cfg_wants_aug)
    if aug_cfg.mosaic and aug_cfg.mixup:
        raise SystemExit(
            "mosaic and mixup together (darknet's combined "
            "mosaic+mixup modes) are not supported — pick one")
    if cfg_wants_aug and not (args.augment or args.mosaic or args.mixup):
        print("cfg augmentation keys present: darknet-style "
              "augmentation enabled (disable with --no-augment)",
              file=sys.stderr)
    if aug_cfg.mosaic and not args.mosaic:
        print("cfg [net] mosaic=1: mosaic augmentation enabled",
              file=sys.stderr)
    if aug_cfg.mixup and not args.mixup:
        print("cfg [net] mixup=1: mixup augmentation enabled",
              file=sys.stderr)
    return aug_cfg


def _grain_iterator(args, cfg, tcfg, pairs, aug_cfg, start_step: int):
    """--loader grain: one checkpointable iterator over every epoch,
    its position restored from <--resume>.grain; under multi-scale the
    size of every step comes from (--seed, step) alone
    (pick_scale_indexed), so a resumed run keeps the ladder."""
    from yolo_tpu_torch.data.grain_pipeline import grain_train_batches

    size_at = None
    if args.multi_scale:
        from yolo_tpu_torch.train.loop import pick_scale_indexed

        def size_at(bi):
            return pick_scale_indexed(bi, args.seed, tcfg.multi_scale_every,
                                      tcfg.multi_scale_sizes)

    it = grain_train_batches(
        pairs, class_names=cfg.class_names, anchors=cfg.anchors,
        num_classes=cfg.num_classes, net_size=cfg.input_hw,
        batch_size=args.batch, seed=args.seed, num_epochs=args.epochs,
        worker_count=args.loader_workers, model_cfg=cfg,
        augment_cfg=aug_cfg, resize=args.resize, channels=cfg.in_channels,
        size_for_batch=size_at)
    if args.resume:
        gpath = args.resume.rstrip("/") + ".grain"
        if os.path.exists(gpath):
            with open(gpath, "rb") as f:
                it.set_state(f.read())
            print(f"restored grain data-iterator position from {gpath}",
                  file=sys.stderr)
        else:
            print(f"no {gpath}: grain iterator restarts from the "
                  f"beginning (model state still resumed)", file=sys.stderr)
        if size_at is not None:
            # pulls after the restore are the absolute steps start_step,
            # start_step + 1, ...: the ladder follows the model's step
            it.base = start_step
    return it


def _eval_samples(args, cfg, pairs):
    if args.eval_split or args.eval_coco_json or args.eval_image_list:
        import argparse

        held_out = args.eval_coco_json or args.eval_image_list
        eargs = argparse.Namespace(
            voc_root=None if held_out else args.voc_root,
            coco_json=args.eval_coco_json or None,
            image_list=args.eval_image_list or None,
            image_root=args.image_root, split=args.eval_split or "val")
        samples = _dataset_samples(eargs, cfg)
    else:
        samples = pairs
        print("--eval-every without --eval-split/--eval-coco-json/"
              "--eval-image-list scores the TRAINING samples",
              file=sys.stderr)
    if args.eval_max_images:
        samples = samples[:args.eval_max_images]
    return samples


def cmd_train(args) -> None:
    """Fine-tuning with the multi-part loss."""
    import dataclasses

    from yolo_tpu_torch.data.pipeline import DevicePrefetcher, train_batches
    from yolo_tpu_torch.io import checkpoint as ckpt
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.parallel.sharding import (batch_sharding,
                                                  make_dp_train_step)
    from yolo_tpu_torch.train.loop import (TrainConfig, init_state,
                                           pick_scale, state_to_tree)
    from yolo_tpu_torch.train.loss import (region_loss_config,
                                           yolo_loss_config)
    from yolo_tpu_torch.utils.metrics import MetricsLogger
    from yolo_tpu_torch.utils.profiling import maybe_trace

    cfg = _get_cfg(args)
    if args.use_tree_map or args.hier_thresh is not None:
        raise SystemExit("--use-tree-map/--hier-thresh shape the "
                         "detection DECODE — training ignores them "
                         "(the hierarchical loss follows the cfg tree "
                         "automatically)")
    if getattr(cfg, "objectness_smooth", False) and args.allow_deviations:
        print("--allow-deviations: [yolo] objectness_smooth=1 has no "
              "pinnable reference semantics — training with SHARP "
              "objectness targets (objectness_smooth=0) instead",
              file=sys.stderr)
        cfg = dataclasses.replace(cfg, objectness_smooth=False)
    if cfg.head_kind == "softmax":
        _train_classifier(args, cfg)
        return
    if not args.weights and not args.resume:
        raise SystemExit("--weights is required for detector training "
                         "(a full .weights file or a darknet `partial` "
                         "backbone, e.g. zoo://darknet19-448-conv23) — "
                         "or --resume a checkpoint")
    if args.imagefolder or args.eval_imagefolder:
        raise SystemExit("--imagefolder/--eval-imagefolder are "
                         f"classifier training data — {cfg.name} is a "
                         "detector; use --voc-root or --coco-json")
    if cfg.head_kind == "detection" and (args.multi_scale
                                         or args.multi_scale_sizes):
        raise SystemExit("yolov1 models have a FIXED input size (the "
                         "[local]/[connected] weights are sized by it) "
                         "— drop --multi-scale")
    if args.resize == "stretch":
        print("training with stretch (letter_box=0) geometry",
              file=sys.stderr)
    net_hp = {}
    if args.cfg:
        from yolo_tpu_torch.configs.darknet_cfg import net_training_params

        net_hp = net_training_params(args.cfg)
    if "letter_box" in net_hp:
        cfg_geom = "letterbox" if net_hp["letter_box"] else "stretch"
        if cfg_geom != args.resize:
            print(f"note: cfg sets letter_box="
                  f"{net_hp['letter_box']} ({cfg_geom} geometry) but "
                  f"--resize {args.resize} is active — pass --resize "
                  f"{cfg_geom} to train like darknet would with this "
                  f"cfg", file=sys.stderr)
    sizes = _multi_scale(args, cfg, net_hp)
    lr = args.lr if args.lr is not None else net_hp.get(
        "learning_rate", 1e-4)
    ema_alpha = (args.ema_alpha if args.ema_alpha is not None
                 else net_hp.get("ema_alpha", 0.0))
    # darknet starts the EMA at max_batches/2 (detector.c)
    ema_start = (args.ema_start_step if args.ema_start_step is not None
                 else net_hp.get("max_batches", 0) // 2)
    burn_in = args.burn_in if args.burn_in is not None else net_hp.get(
        "burn_in", 0)
    tcfg = TrainConfig(learning_rate=lr, **_optimizer_from(args, net_hp),
                       **_lr_schedule_from(args, net_hp),
                       multi_scale=args.multi_scale, remat=args.remat,
                       burn_in_steps=burn_in,
                       momentum=net_hp.get("momentum", 0.9),
                       weight_decay=net_hp.get("decay", 5e-4),
                       grad_accum=_batch_accum_from(args, net_hp),
                       ema_alpha=ema_alpha, ema_start_step=ema_start,
                       loss=region_loss_config(cfg),
                       yolo_loss=yolo_loss_config(cfg),
                       **({"multi_scale_sizes": sizes} if sizes else {}),
                       **({"multi_scale_every": args.multi_scale_every}
                          if args.multi_scale_every is not None else {}))
    if args.eval_split and (args.coco_json or args.image_list):
        raise SystemExit("--eval-split is a VOC concept; use "
                         "--eval-coco-json (COCO) or --eval-image-list "
                         "(darknet list) for a held-out set")
    aug_cfg = _augment_config(args, net_hp)
    dtype = _compute_dtype(args.precision)
    device = _device(args)

    if args.resume:
        state = _restore_adapt_ema(args.resume, cfg, tcfg, device)
    else:
        # a full .weights file or a darknet `partial` backbone: the
        # prefix loads, the rest is randomly initialized
        from yolo_tpu_torch.configs.specs import weighted_specs

        params, header, n_loaded = dw.load_partial(
            _resolve_weights(args.weights), cfg.layers,
            input_channels=cfg.in_channels)
        n_total = len(weighted_specs(cfg.layers))
        if n_loaded < n_total:
            fresh = dw.random_params(cfg.layers,
                                     np.random.default_rng(args.seed),
                                     scale=0.03,
                                     input_channels=cfg.in_channels)
            params = params + fresh[n_loaded:]
            print(f"partial init: {n_loaded}/{n_total} weighted layers "
                  f"from {args.weights}, rest randomly initialized "
                  f"(darknet backbone-transfer workflow)", file=sys.stderr)
        state = init_state(cfg, params, tcfg,
                           seen=header["seen"] if args.keep_seen else 0,
                           device=device)
    mesh = _train_mesh(args, state.net.device)
    step_fn = make_dp_train_step(cfg, tcfg, mesh, compute_dtype=dtype)

    pairs = _dataset_samples(args, cfg)
    eval_samples = (_eval_samples(args, cfg, pairs) if args.eval_every
                    else None)
    rng = np.random.default_rng(args.seed)
    logger = MetricsLogger(path=args.log_file, every=args.log_every)
    if args.prewarm and tcfg.multi_scale:
        print("--prewarm: eager PyTorch compiles nothing ahead; each size "
              "bucket runs as it comes", file=sys.stderr)

    best_map = -1.0
    size_fn = ((lambda bi: pick_scale(bi, rng, tcfg.multi_scale_every,
                                      tcfg.multi_scale_sizes))
               if tcfg.multi_scale else None)

    def epoch_batches():
        return train_batches(
            pairs, class_names=cfg.class_names, anchors=cfg.anchors,
            num_classes=cfg.num_classes, net_size=cfg.input_hw,
            batch_size=args.batch, rng=rng, size_for_batch=size_fn,
            augment_cfg=aug_cfg, model_cfg=cfg, resize=args.resize,
            channels=cfg.in_channels)

    start_step = state.step
    steps_per_epoch = max(len(pairs) // args.batch, 1)
    grain_iter = (_grain_iterator(args, cfg, tcfg, pairs, aug_cfg,
                                  start_step)
                  if args.loader == "grain" else None)

    with ckpt.AsyncSaver() as saver:
        def save_ckpt(name: str) -> None:
            path = os.path.join(args.checkpoint_dir, name)
            saver.save(path, state_to_tree(state), model=cfg.name)
            if grain_iter is not None:
                # the position that regenerates the first batch not yet
                # trained, whatever the prefetcher pulled ahead
                os.makedirs(args.checkpoint_dir, exist_ok=True)
                with open(path.rstrip("/") + ".grain", "wb") as f:
                    f.write(grain_iter.state_for_pull(state.step
                                                      - start_step))

        # grain spans every epoch in one iterator: the epoch is logged
        # from the step
        epoch_iters = ([(None, grain_iter)] if grain_iter is not None
                       else ((e, epoch_batches())
                             for e in range(args.epochs)))
        t_last = time.perf_counter()
        with maybe_trace(args.profile_dir):
            for epoch, host_iter in epoch_iters:
                staged = DevicePrefetcher(host_iter, depth=2,
                                          sharding=batch_sharding(mesh))
                with staged:
                    for batch in staged:
                        metrics = step_fn(state, batch)
                        step = state.step
                        now = time.perf_counter()
                        img_s = args.batch / max(now - t_last, 1e-9)
                        t_last = now
                        logger.log(step, metrics,
                                   epoch=(epoch if epoch is not None
                                          else (step - 1)
                                          // steps_per_epoch),
                                   size=_net_size(batch),
                                   img_s=round(img_s, 1))
                        if args.eval_every and step % args.eval_every == 0:
                            best_map = _validate(args, cfg, state,
                                                 eval_samples, dtype,
                                                 logger, best_map,
                                                 save_ckpt)
                            t_last = time.perf_counter()
                        if (args.checkpoint_dir
                                and step % args.checkpoint_every == 0):
                            save_ckpt(f"step_{step}")
                            t_last = time.perf_counter()
                        if args.fail_after_step \
                                and step >= args.fail_after_step:
                            raise SystemExit(
                                f"--fail-after-step {args.fail_after_step}"
                                f" reached (fault-injection debug flag)")
        if args.checkpoint_dir:
            save_ckpt("final")
    if args.checkpoint_dir:
        print(f"saved final checkpoint to {args.checkpoint_dir}/final",
              file=sys.stderr)
    logger.close()


def _validate(args, cfg, state, eval_samples, dtype, logger, best_map,
              save_ckpt) -> float:
    """--eval-every: the validation mAP of the EMA (or live) weights,
    logged as val_map; a better one saves the 'best' checkpoint."""
    from yolo_tpu_torch.eval.runner import quick_map
    from yolo_tpu_torch.train.loop import ema_params_of

    m = quick_map(cfg, ema_params_of(state), eval_samples,
                  batch=min(args.batch, 16), compute_dtype=dtype,
                  resize=args.resize, device=state.net.device)
    logger.log(state.step, {"val_map": round(m, 4)}, force=True)
    print(f"step {state.step}: validation mAP {m:.4f}", file=sys.stderr)
    if args.checkpoint_dir and m > best_map:
        save_ckpt("best")
        print(f"new best mAP {m:.4f} -> {args.checkpoint_dir}/best",
              file=sys.stderr)
        return m
    return best_map
