"""Trainer plumbing (port of yolo_tpu/cli/train_helpers.py): checkpoint
restore with the EMA adaptation, and the darknet [net]-driven batch,
optimizer and LR-schedule resolution. The classifier trainer
(_train_classifier) is ROADMAP A10."""

from __future__ import annotations

import sys


def _train_classifier(args, cfg) -> None:
    raise SystemExit("classifier training (--imagefolder, softmax heads) "
                     "is not ported yet (ROADMAP A10)")


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
    policy rejects — its per-step rand_uniform draw has no
    deterministic equivalent). Returns TrainConfig schedule kwargs."""
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
        # its draw is jax.random's: the port does not reproduce it yet
        raise SystemExit("[net] policy=random (a random LR draw each "
                         "batch) is not ported yet (ROADMAP A9e)")
    elif policy not in ("constant", "steps"):
        # darknet get_policy: unknown strings warn and fall back
        print(f"note: unknown [net] policy '{policy}', going with "
              "constant (darknet does the same)", file=sys.stderr)
    return kw
