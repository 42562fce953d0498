"""Trainer plumbing (port of yolo_tpu/cli/train_helpers.py): the
classifier trainer (_train_classifier), checkpoint restore with the EMA
adaptation, and the darknet [net]-driven batch, optimizer and
LR-schedule resolution."""

from __future__ import annotations

import sys


def _train_classifier(args, cfg) -> None:
    """Classifier (softmax-head) training on an imagefolder: softmax
    cross-entropy (train/loss.py::classifier_loss), with the detector
    trainer's optimizer, LR schedules, EMA and checkpoints; completes
    darknet's pretrain workflow: train a classifier -> `partial` ->
    fine-tune a detector. --eval-every scores --eval-imagefolder's top-1
    with the EMA (or live) weights and keeps the best checkpoint."""
    import os
    import time

    import numpy as np

    from yolo_tpu_torch.cli._common import (_compute_dtype, _device,
                                            _resolve_weights)
    from yolo_tpu_torch.data.imagefolder import (classifier_train_batches,
                                                 list_imagefolder,
                                                 steps_per_epoch)
    from yolo_tpu_torch.data.pipeline import DevicePrefetcher
    from yolo_tpu_torch.io import checkpoint as ckpt
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.parallel.sharding import (batch_sharding,
                                                  make_dp_train_step)
    from yolo_tpu_torch.train.loop import (TrainConfig, init_state,
                                           state_to_tree)
    from yolo_tpu_torch.utils.metrics import MetricsLogger
    from yolo_tpu_torch.utils.profiling import maybe_trace

    if not args.imagefolder:
        raise SystemExit(f"{cfg.name} is a classifier — training data "
                         "is an imagefolder (--imagefolder DIR with "
                         "<dir>/<class>/<image> layout), not "
                         "--voc-root/--coco-json")
    if args.voc_root or args.coco_json:
        raise SystemExit("classifier training takes --imagefolder, not "
                         "--voc-root/--coco-json")
    for flag, name in ((args.multi_scale, "--multi-scale"),
                       (args.mosaic, "--mosaic"),
                       (args.mixup, "--mixup"),
                       (args.loader == "grain", "--loader grain")):
        if flag:
            raise SystemExit(f"{name} applies to detector training "
                             "only (classifier training augments with "
                             "a seeded flip; --no-augment disables)")
    dtype = _compute_dtype(args.precision)
    device = _device(args)
    eval_arrays = eval_samples = None
    if args.eval_every:
        from yolo_tpu_torch.models.classify import preprocess_samples

        eval_dir = args.eval_imagefolder or args.imagefolder
        if not args.eval_imagefolder:
            print("--eval-every without --eval-imagefolder scores the "
                  "TRAINING images", file=sys.stderr)
        eval_samples = list_imagefolder(eval_dir, cfg.class_names)
        if args.eval_max_images:
            eval_samples = eval_samples[:args.eval_max_images]
        # decoded once while the cache stays small; past the cap each
        # eval streams from disk
        if len(eval_samples) <= 2048:
            eval_arrays = preprocess_samples(eval_samples, cfg.input_hw,
                                             cfg.in_channels)
            print(f"cached {len(eval_samples)} preprocessed eval "
                  f"images", file=sys.stderr)
        else:
            print(f"{len(eval_samples)} eval images exceed the 2048 "
                  f"preprocess cache cap — each eval streams from "
                  f"disk (--eval-max-images to cache a subset)",
                  file=sys.stderr)

    net_hp = {}
    if args.cfg:
        from yolo_tpu_torch.configs.darknet_cfg import net_training_params

        net_hp = net_training_params(args.cfg)
    lr = args.lr if args.lr is not None else net_hp.get(
        "learning_rate", 1e-3)
    burn_in = args.burn_in if args.burn_in is not None else net_hp.get(
        "burn_in", 0)
    ema_alpha = (args.ema_alpha if args.ema_alpha is not None
                 else net_hp.get("ema_alpha", 0.0))
    ema_start = (args.ema_start_step if args.ema_start_step is not None
                 else net_hp.get("max_batches", 0) // 2)
    tcfg = TrainConfig(learning_rate=lr, **_optimizer_from(args, net_hp),
                       **_lr_schedule_from(args, net_hp),
                       remat=args.remat, burn_in_steps=burn_in,
                       momentum=net_hp.get("momentum", 0.9),
                       weight_decay=net_hp.get("decay", 5e-4),
                       grad_accum=_batch_accum_from(args, net_hp),
                       ema_alpha=ema_alpha, ema_start_step=ema_start)

    if args.resume:
        state = _restore_adapt_ema(args.resume, cfg, tcfg, device)
    elif args.weights:
        # a full .weights file or a darknet partial; the rest random
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
                  f"from {args.weights}, rest randomly initialized",
                  file=sys.stderr)
        state = init_state(cfg, params, tcfg,
                           seen=header["seen"] if args.keep_seen else 0,
                           device=device)
    else:
        # darknet classifiers train from scratch by default
        params = dw.random_params(cfg.layers,
                                  np.random.default_rng(args.seed),
                                  scale=0.03,
                                  input_channels=cfg.in_channels)
        state = init_state(cfg, params, tcfg, device=device)
        print("no --weights: training from random initialization "
              f"(seed {args.seed})", file=sys.stderr)
    mesh = _train_mesh(args, state.net.device)
    step_fn = make_dp_train_step(cfg, tcfg, mesh, compute_dtype=dtype)

    samples = list_imagefolder(args.imagefolder, cfg.class_names)
    print(f"{len(samples)} images, {cfg.num_classes} classes",
          file=sys.stderr)
    aug_cfg = None
    cls_aug_keys = ("saturation", "exposure", "hue", "flip",
                    "angle", "aspect", "min_crop", "max_crop")
    if (args.augment or any(k in net_hp for k in cls_aug_keys)) \
            and not args.no_augment:
        # darknet classifier training distorts HSV and, where the cfg
        # asks, takes random_augment_image's scale/rotation crop (the
        # cfg's keys, or --augment for the classic HSV + flip)
        from yolo_tpu_torch.data.augment import config_from_net_params

        aug_cfg = config_from_net_params(
            net_hp,
            force_defaults=not any(k in net_hp for k in cls_aug_keys))
        if aug_cfg.mosaic or aug_cfg.mixup:
            raise SystemExit("mosaic/mixup are detection augmentations "
                             "— classifier training supports HSV+flip "
                             "and [net] angle/aspect/min_crop/max_crop")
        geom = (" + scale/rotation crops"
                if aug_cfg.classifier_geometry else "")
        print(f"classifier HSV+flip augmentation enabled{geom}",
              file=sys.stderr)
    if state.step:
        print(f"data position: resuming the stream at step "
              f"{state.step} (position-independent shuffle/flip keys)",
              file=sys.stderr)
    host_iter = classifier_train_batches(
        samples, args.batch, cfg.input_hw, epochs=args.epochs,
        seed=args.seed, flip=not args.no_augment, start_step=state.step,
        augment_cfg=aug_cfg, channels=cfg.in_channels)
    logger = MetricsLogger(path=args.log_file, every=args.log_every)
    spe = steps_per_epoch(len(samples), args.batch)
    best_top1 = -1.0

    with ckpt.AsyncSaver() as saver:
        def save_ckpt(name: str) -> None:
            saver.save(os.path.join(args.checkpoint_dir, name),
                       state_to_tree(state), model=cfg.name)

        t_last = time.perf_counter()
        with maybe_trace(args.profile_dir), \
                DevicePrefetcher(host_iter, depth=2,
                                 sharding=batch_sharding(mesh)) as staged:
            for batch in staged:
                metrics = step_fn(state, batch)
                step = state.step
                now = time.perf_counter()
                img_s = args.batch / max(now - t_last, 1e-9)
                t_last = now
                logger.log(step, metrics, epoch=(step - 1) // spe,
                           size=_net_size(batch),
                           img_s=round(img_s, 1))
                if args.eval_every and step % args.eval_every == 0:
                    top1 = _validate_classifier(args, cfg, state, dtype,
                                                eval_arrays, eval_samples)
                    logger.log(step, {"val_top1": top1}, force=True)
                    print(f"step {step}: validation top-1 {top1:.4f}",
                          file=sys.stderr)
                    if args.checkpoint_dir and top1 > best_top1:
                        best_top1 = top1
                        save_ckpt("best")
                        print(f"new best top-1 {top1:.4f} -> "
                              f"{args.checkpoint_dir}/best",
                              file=sys.stderr)
                    t_last = time.perf_counter()
                if args.checkpoint_dir and step % args.checkpoint_every == 0:
                    save_ckpt(f"step_{step}")
                    t_last = time.perf_counter()
                if args.fail_after_step and step >= args.fail_after_step:
                    raise SystemExit(
                        f"--fail-after-step {args.fail_after_step} "
                        f"reached (fault-injection debug flag)")
        if args.checkpoint_dir:
            save_ckpt("final")
    if args.checkpoint_dir:
        print(f"saved final checkpoint to {args.checkpoint_dir}/final",
              file=sys.stderr)
    logger.close()


def _validate_classifier(args, cfg, state, dtype, eval_arrays,
                         eval_samples) -> float:
    """The validation top-1 of the EMA (or live) weights, folded into an
    inference net on the state's device."""
    import torch

    from yolo_tpu_torch.models.classify import (accuracy_from_arrays,
                                                imagefolder_accuracy)
    from yolo_tpu_torch.models.graph import Darknet, fold_params
    from yolo_tpu_torch.train.loop import ema_params_of

    net = Darknet(cfg.layers, fold_params(cfg.layers, ema_params_of(state),
                                          cfg.bn_eps),
                  device=state.net.device, dtype=dtype)
    batch = min(args.batch, 32)
    with torch.no_grad():
        acc = (accuracy_from_arrays(cfg, net, *eval_arrays, batch=batch)
               if eval_arrays is not None else
               imagefolder_accuracy(cfg, net, eval_samples, batch=batch))
    return acc["top1"]


def _net_size(batch) -> int:
    """The image height of a batch, whole or sharded over a mesh."""
    return int((batch[0] if isinstance(batch, tuple)
                else batch)["images"].shape[1])


def _train_mesh(args, device):
    """The data-parallel mesh of a train command: every card of this
    process (one mesh entry each; a mesh of one card steps as
    make_train_step does), or the CPU under --device cpu. --batch must
    divide by its size."""
    from yolo_tpu_torch.parallel import sharding as shd

    mesh = (shd.make_mesh() if device.type == "cuda"
            else shd.make_mesh(devices=[device]))
    if args.batch % len(mesh):
        raise SystemExit(f"--batch {args.batch} not divisible by "
                         f"{len(mesh)} devices")
    return mesh


def _restore_adapt_ema(resume_path: str, mcfg, tcfg, device):
    """A TrainState from a checkpoint of the port. The EMA track may
    differ between the checkpoint and this run: a checkpoint without one
    resumed with ema_alpha starts it from the restored weights; one with
    a track resumed without ema_alpha drops it."""
    from yolo_tpu_torch.io import checkpoint as ckpt
    from yolo_tpu_torch.train.loop import state_from_tree

    try:
        tree = ckpt.restore(resume_path)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e)) from None
    ckpt_has_ema = "ema_params" in tree
    want_ema = bool(tcfg.ema_alpha)
    try:
        state = state_from_tree(tree, mcfg, tcfg, device=device)
    except ValueError as e:
        raise SystemExit(f"--resume {resume_path}: {e}") from None
    if ckpt_has_ema and not want_ema:
        print("checkpoint carries an EMA track but this run has "
              "ema_alpha=0 — dropping it (pass --ema-alpha to keep "
              "blending)", file=sys.stderr)
    elif want_ema and not ckpt_has_ema:
        print("checkpoint has no EMA track — starting one from the "
              "restored weights", file=sys.stderr)
    print(f"resumed from {resume_path} at step {state.step}",
          file=sys.stderr)
    return state


def _batch_accum_from(args, net_hp) -> int:
    """--batch/--grad-accum resolution shared by both trainers:
    explicit flags win, then the cfg's [net] batch/subdivisions (the
    darknet training config), else 32/1. Mutates args.batch in place
    (downstream code reads it everywhere) and returns the accumulation
    count. darknet requires batch % subdivisions == 0; so do we."""
    if args.batch is None:
        args.batch = int(net_hp.get("batch", 32))
        if "batch" in net_hp:
            print(f"cfg [net] batch={args.batch}", file=sys.stderr)
    accum = (args.grad_accum if args.grad_accum is not None
             else int(net_hp.get("subdivisions", 1)))
    if accum != 1 and args.grad_accum is None:
        print(f"cfg [net] subdivisions={accum}: accumulating "
              f"gradients over {accum} sub-batches of "
              f"{args.batch // max(accum, 1)} (per-sub-batch BN "
              f"stats, darknet semantics); pass --grad-accum 1 for "
              f"one whole-batch pass per step", file=sys.stderr)
    if accum < 1 or args.batch % accum:
        raise SystemExit(
            f"--batch {args.batch} is not divisible by grad-accum "
            f"{accum} (darknet requires batch % subdivisions == 0) — "
            f"adjust --batch or pass --grad-accum 1")
    return accum


def _optimizer_from(args, net_hp) -> dict:
    """Optimizer resolution shared by both trainers: the explicit
    --optimizer flag wins, then the cfg's [net] adam=1 (darknet's
    switch), else SGD; cfg B1/B2/eps become the Adam moments."""
    opt = args.optimizer or ("adam" if net_hp.get("adam") else "sgd")
    kw = {"optimizer": opt}
    if opt == "adam":
        kw.update(adam_b1=net_hp.get("B1", 0.9),
                  adam_b2=net_hp.get("B2", 0.999),
                  adam_eps=net_hp.get("eps", 1e-7))
        if net_hp.get("adam") and not args.optimizer:
            print("cfg [net] adam=1: Adam optimizer "
                  f"(B1={kw['adam_b1']:g}, B2={kw['adam_b2']:g}, "
                  f"eps={kw['adam_eps']:g})", file=sys.stderr)
    return kw


def _lr_schedule_from(args, net_hp):
    """Darknet LR-schedule resolution shared by detector and classifier
    training: explicit --lr-steps/--lr-scales win, then the cfg's [net]
    policy (the full network.c get_current_rate set: steps | poly |
    step | exp | sigmoid | sgdr | constant; the stochastic 'random'
    policy only with --allow-deviations, as a seeded draw keyed on
    (--seed, step)). Returns TrainConfig schedule kwargs."""
    kw = {"lr_decay_steps": (), "lr_decay_scales": ()}
    policy = net_hp.get("policy", "constant")
    # [net] power feeds both the burn-in ramp and the poly decay
    # (network.c net.power, default 4) whatever the policy, so it is set
    # before the --lr-steps early return
    kw["lr_poly_power"] = float(net_hp.get("power", 4.0))
    if args.lr_scales and not args.lr_steps:
        raise SystemExit("--lr-scales requires --lr-steps (to override "
                         "a cfg's [net] schedule, give both)")
    if args.lr_steps:
        decay_steps = tuple(int(s) for s in args.lr_steps.split(","))
        if args.lr_scales:
            decay_scales = tuple(float(s) for s in args.lr_scales.split(","))
            if len(decay_steps) != len(decay_scales):
                raise SystemExit("--lr-steps and --lr-scales lengths differ")
        else:
            decay_scales = (0.1,) * len(decay_steps)  # darknet default
        kw.update(lr_decay_steps=decay_steps,
                  lr_decay_scales=decay_scales)
        return kw
    if policy == "steps":
        # darknet hard-errors on policy=steps without steps+scales
        if "steps" not in net_hp or "scales" not in net_hp:
            raise SystemExit("[net] policy=steps needs both steps and "
                             "scales (darknet refuses this cfg too); "
                             "or give --lr-steps/--lr-scales")
        decay_steps = net_hp["steps"]
        decay_scales = net_hp["scales"]
        if len(decay_steps) != len(decay_scales):
            raise SystemExit("[net] steps and scales lengths differ")
        kw.update(lr_decay_steps=decay_steps,
                  lr_decay_scales=decay_scales)
    elif "steps" in net_hp:
        # steps/scales present but the policy doesn't use them
        # (darknet's default policy when the key is absent is constant)
        print(f"note: ignoring [net] steps/scales (policy is "
              f"'{policy}'; steps apply under policy=steps)",
              file=sys.stderr)
    if policy == "poly":
        if not net_hp.get("max_batches"):
            raise SystemExit("[net] policy=poly needs max_batches "
                             "(darknet's decay horizon)")
        kw["lr_poly_max_steps"] = int(net_hp["max_batches"])
        print(f"cfg policy=poly: lr decays as "
              f"(1 - step/{kw['lr_poly_max_steps']})"
              f"^{kw['lr_poly_power']:g}", file=sys.stderr)
    elif policy == "step":
        # darknet STEP: lr * scale^(batch//step) (parser defaults 1/1)
        kw["lr_step_size"] = int(net_hp.get("step", 1))
        kw["lr_step_scale"] = float(net_hp.get("scale", 1.0))
        print(f"cfg policy=step: lr *= {kw['lr_step_scale']:g} every "
              f"{kw['lr_step_size']} steps", file=sys.stderr)
    elif policy == "exp":
        kw["lr_exp_gamma"] = float(net_hp.get("gamma", 1.0))
        if kw["lr_exp_gamma"] <= 0:
            # the schedule gates terms on gamma's truthiness: a 0 would
            # train at constant lr where darknet trains at lr*0^batch = 0
            raise SystemExit(f"[net] policy=exp gamma="
                             f"{kw['lr_exp_gamma']:g} must be > 0 "
                             f"(darknet would train at lr*gamma^batch "
                             f"= 0)")
        print(f"cfg policy=exp: lr * {kw['lr_exp_gamma']:g}^step",
              file=sys.stderr)
    elif policy == "sigmoid":
        kw["lr_sig_gamma"] = float(net_hp.get("gamma", 1.0))
        if kw["lr_sig_gamma"] <= 0:
            raise SystemExit(f"[net] policy=sigmoid gamma="
                             f"{kw['lr_sig_gamma']:g} must be > 0 "
                             f"(0 would silently train at constant "
                             f"lr here but lr/2 in darknet)")
        kw["lr_sig_step"] = int(net_hp.get("step", 1))
        print(f"cfg policy=sigmoid: lr / (1 + e^({kw['lr_sig_gamma']:g}"
              f"*(step - {kw['lr_sig_step']})))", file=sys.stderr)
    elif policy == "sgdr":
        # AlexeyAB SGDR (cosine warm restarts): sgdr_cycle defaults to
        # max_batches, sgdr_mult to 2, learning_rate_min to 1e-5
        cycle = int(net_hp.get("sgdr_cycle",
                               net_hp.get("max_batches", 0)))
        if not cycle:
            raise SystemExit("[net] policy=sgdr needs sgdr_cycle or "
                             "max_batches (the first cycle length)")
        kw["lr_sgdr_cycle"] = cycle
        kw["lr_sgdr_mult"] = int(net_hp.get("sgdr_mult", 2))
        kw["lr_min"] = float(net_hp.get("learning_rate_min", 1e-5))
        print(f"cfg policy=sgdr: cosine warm restarts, first cycle "
              f"{cycle}, mult {kw['lr_sgdr_mult']}, "
              f"lr_min {kw['lr_min']:g}", file=sys.stderr)
    elif policy == "random":
        if not getattr(args, "allow_deviations", False):
            raise SystemExit(
                "[net] policy=random draws a fresh rand_uniform^power "
                "LR every batch from the C library's global PRNG — "
                "irreproducible by design. Pass --allow-deviations to "
                "train it with darknet's formula (lr * u^power, "
                "u ~ U[0,1)) under a SEEDED draw keyed on "
                "(--seed, step): deterministic and "
                "resume-reproducible — the deviation is determinism, "
                "not the formula.")
        kw["lr_random"] = True
        kw["lr_random_seed"] = int(getattr(args, "seed", 0) or 0)
        print("--allow-deviations: [net] policy=random trains with a "
              "SEEDED rand_uniform^power LR draw keyed on "
              f"(--seed={kw['lr_random_seed']}, step) — darknet's "
              "formula, deterministic instead of the C rand()",
              file=sys.stderr)
    elif policy not in ("constant", "steps"):
        # darknet get_policy: unknown strings warn and fall back
        print(f"note: unknown [net] policy '{policy}', going with "
              "constant (darknet does the same)", file=sys.stderr)
    return kw
