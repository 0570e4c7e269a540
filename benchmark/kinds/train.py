"""The training mixes (kind `train`): a closed loop through the program's
`train.make_train_step` over a pool of distinct batches, and its check.

Set-up builds one training object (model, AdamW, the step, under DDP over
the mix's ranks) with weights from the seed, and drives it through the
mix's checked steps on pool batches 0, 1, 2 (rows that all differ), each
with its stochastic-depth generator keyed by (seed, step, rank). These
steps are the warm-up too. Their readings: each step's loss, step 1's
prediction (a forward hook on the model), the first gradient as AdamW
holds it after step 1 (exp_avg / (1 - beta1)) and each leaf's change
after the last checked step, as norms per leaf. The same
object then runs the window: steps on the pool's batches in turn, with a
one-step-deep loss pipeline (step N's loss is read once step N+1 is
queued), until `--seconds` have passed; the window ends at a synchronise.
Over several ranks (the mix's `world`, one process a card) the ranks agree
on the window's end on the card, a step late (`window`).

After the window the program is freed and the reference (float32, TF32
off) follows the checked steps from the same weights, rows and draws, in
blocks of rows.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import device as hw
from benchmark import inputs, judge, kinds, tracing
from benchmark.reference.model import FBANet as RefModel
from benchmark.reference.model import draw_masks
from benchmark.reference.objectives import AdamW, training_loss
from benchmark.reference.precision import F32, Precision

_DROP_KEY = 0xD50  # stochastic depth generators: (seed, _DROP_KEY, step, rank)
_ADAM_BETA1 = 0.9


def pool(cell, seed: int, device, rows: slice) -> list:
    """The mix's pool of distinct batches, this rank's rows of each."""
    mix, m = cell.mix, cell.model
    out = []
    for i in range(mix["pool"]):
        lr, hr = inputs.bursts(seed, i, mix["batch"], m["num_frames"],
                               m["img_size"], m["in_channels"],
                               mix["shift_px"], device)
        out.append((lr[rows].contiguous(), hr[rows].contiguous()))
    return out


def step_generator(device, seed: int, step: int, rank: int):
    return inputs.generator(device, seed, _DROP_KEY, step, rank)


def flat(tensors: dict) -> torch.Tensor:
    """The leaves of {name: tensor} as one float32 vector, in name order."""
    return torch.cat([tensors[n].detach().float().reshape(-1)
                      for n in sorted(tensors)])


class Program:
    """The program's training object after set-up, and its readings."""

    def __init__(self, cell, seed: int, device, world,
                 fault: str | None = None):
        from fbanet_tpu_torch.config import ModelConfig, TrainConfig
        from fbanet_tpu_torch.models.fbanet import FBANet
        from fbanet_tpu_torch.train import make_optimizer, make_train_step

        m, mix, tr = cell.model, cell.mix, cell.config["train"]
        self.cell, self.seed, self.device = cell, seed, device
        self.world = world
        self.lr = tr["lr"]
        rows = world.rows(mix["batch"])
        if fault == "half":  # half the batch left out, the mean over the rest
            rows = slice(rows.start, (rows.start + rows.stop) // 2)
        self.pool = pool(cell, seed, device, rows)
        mcfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
        with torch.device(device):
            model = FBANet(mcfg)
        model.to(device)
        weights = inputs.make_weights(inputs.parameter_shapes(model), seed,
                                      device)
        model.load_state_dict(weights, strict=True)
        tcfg = TrainConfig(batch_size=mix["batch"], optimizer=tr["optimizer"],
                           lr_initial=tr["lr"],
                           weight_decay=tr["weight_decay"],
                           gw_loss_weight=tr["gw_loss_weight"],
                           charbonnier_eps=tr["charbonnier_eps"])
        opt = make_optimizer(model.parameters(), tcfg)
        step = make_train_step(model, opt, tcfg, world=world)
        if fault == "frozen":  # a step that returns its state unchanged
            opt.step = lambda *a, **k: None
        if fault == "no_exchange":  # the exchange between chips left out
            def local(_state, bucket):
                fut = torch.futures.Future()
                fut.set_result(bucket.buffer())
                return fut
            step.ddp.register_comm_hook(None, local)
        self.model, self.opt, self.step_fn = model, opt, step
        self.steps = 0
        self.readings = self._checked_steps(weights, mix["check_steps"])

    def step(self):
        """Queue one step on the next pool batch; returns its loss tensor."""
        i = self.steps
        lr, hr = self.pool[i % len(self.pool)]
        gen = step_generator(self.device, self.seed, i, self.world.rank)
        loss = self.step_fn(lr, hr, gen, self.lr)
        self.steps += 1
        return loss

    def _checked_steps(self, w0: dict, n: int) -> dict:
        losses, grad, pred = [], None, []
        params = dict(self.model.named_parameters())
        hook = self.model.register_forward_hook(  # step 1's prediction
            lambda _m, _a, out: pred.append(out.detach().float().cpu()))
        for k in range(n):
            losses.append(float(self.step()))
            if k == 0:
                hook.remove()
                grad = {}
                for name, p in params.items():
                    m = self.opt.state.get(p, {}).get("exp_avg")
                    grad[name] = (0.0 if m is None else
                                  float(m.float().norm()) / (1 - _ADAM_BETA1))
        delta = flat(params) - flat(w0)
        return {"losses": losses, "grad": grad, "delta": delta,
                "pred": pred[0]}

    def gathered(self) -> dict:
        """The readings; over several ranks, with every rank's gradient
        norms and change as lists (on every rank)."""
        r = self.readings
        if self.world.size == 1:
            return r
        import torch.distributed as dist

        names = sorted(r["grad"])
        g = torch.tensor([r["grad"][n] for n in names], dtype=torch.float64,
                         device=self.device)
        gs = [torch.empty_like(g) for _ in range(self.world.size)]
        dist.all_gather(gs, g)
        ds = [torch.empty_like(r["delta"]) for _ in range(self.world.size)]
        dist.all_gather(ds, r["delta"])
        pred = r["pred"].to(self.device)
        ps = [torch.empty_like(pred) for _ in range(self.world.size)]
        dist.all_gather(ps, pred)
        return {"losses": r["losses"],
                "grad": [dict(zip(names, x.tolist())) for x in gs],
                "delta": ds, "pred": torch.cat(ps).cpu()}

    def free(self):
        del self.model, self.opt, self.step_fn, self.pool
        gc.collect()
        hw.empty_cache()


def reference(cell, seed: int, device, world_size: int,
              prec: Precision = F32) -> dict:
    """The reference's readings of the checked steps: the same weights,
    rows and stochastic-depth draws as the program's (each rank's rows with
    that rank's generator), the whole global batch's mean loss, in blocks
    of `mix["ref_rows"]` rows; `prec` the precision of its products."""
    m, mix, tr = cell.model, cell.mix, cell.config["train"]
    batch, per = mix["batch"], mix["batch"] // world_size
    block = min(mix["ref_rows"], per)
    ref = RefModel(m).to(device)
    w0 = inputs.make_weights(inputs.parameter_shapes(ref), seed, device)
    ref.load_state_dict(w0, strict=True)
    opt = AdamW(ref.parameters(), tr["lr"], tr["weight_decay"])
    rates = ref.drop_rates()
    params = dict(ref.named_parameters())
    losses, grad, preds = [], None, []
    for k in range(mix["check_steps"]):
        lr_all, hr_all = inputs.bursts(seed, k, batch, m["num_frames"],
                                       m["img_size"], m["in_channels"],
                                       mix["shift_px"], device)
        for p in ref.parameters():
            p.grad = None
        total = torch.zeros((), device=device)
        blocks = []
        for r in range(world_size):
            masks = draw_masks(rates, per, step_generator(device, seed, k, r))
            for b0 in range(0, per, block):
                blocks.append((r * per + b0, r * per + min(per, b0 + block),
                               [mk[b0:b0 + block] for mk in masks]))
        n_rows = sum(b - a for a, b, _ in blocks)
        for a, b, mk in blocks:
            x = lr_all[a:b].float() / 255.0
            y = hr_all[a:b].float() / 255.0
            pred = ref(x, prec, masks=mk)
            if k == 0:
                preds.append(pred.detach())
            loss = training_loss(pred, y, tr["charbonnier_eps"],
                                 tr["gw_loss_weight"]) * ((b - a) / n_rows)
            loss.backward()
            total += loss.detach()
            del pred, loss
        losses.append(float(total))
        if k == 0:
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
            grad = {n: float(g.norm()) for n, g in grads.items()}
            grad_flat = flat(grads)
        opt.step()
    delta = flat(params) - flat(w0)
    del ref, opt, w0
    gc.collect()
    return {"losses": losses, "grad": grad, "grad_flat": grad_flat,
            "delta": delta, "pred": torch.cat(preds),
            "layout": [(n, params[n].numel()) for n in sorted(params)]}


def _agreement(world, dev):
    """Over several ranks, `agree(start, stop)`: every rank's wishes,
    filled on the card and all-reduced (max) behind the step just queued,
    then copied to pinned host memory with an event recorded after the
    copy. Nothing in it waits on the host. None on one rank."""
    if world.size == 1:
        return None
    import torch.distributed as dist

    def agree(start: bool, stop: bool):
        t = torch.empty(2, dtype=torch.int32, device=dev)
        t[:1].fill_(int(start))
        t[1:].fill_(int(stop))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if not hw.is_cuda(dev):
            return t, None
        host = torch.empty(2, dtype=torch.int32, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return agree


def _decided(agreed) -> tuple[bool, bool]:
    """The ranks' agreed (start, stop), waiting for no more than it."""
    host, done = agreed
    if done is not None:
        done.synchronize()
    start, stop = host.tolist()
    return bool(start), bool(stop)


def window(prog: Program, seconds: float, sub=None, agree=None) -> dict:
    """Steps until `seconds` have passed. With `sub` (tracing.SubWindow),
    the last `profile_steps` steps are profiled, the window running on
    until they are done. Over several ranks `agree` (`_agreement`) queues
    every rank's wishes behind each step; the ranks act on step N-1's
    agreement once step N is queued and step N-1's loss read, which has
    waited for more already, so the agreement adds no wait on the host to
    the program's one-deep loss pipeline, and every rank stops after the
    same step."""
    profile_steps = prog.cell.mix["profile_steps"]
    hw.sync(prog.device)
    t0 = time.perf_counter()
    n, pending, agreed, losses = 0, None, None, []
    while True:
        with torch.profiler.record_function("bench.step"):
            loss = prog.step()
        n += 1
        if sub is not None and sub.active:
            sub.steps += 1
        el = time.perf_counter() - t0
        start = (sub is not None and not sub.active
                 and el + profile_steps * el / n >= seconds)
        stop = el >= seconds and (sub is None or sub.steps >= profile_steps)
        if agree is not None:
            agreed, earlier = agree(start, stop), agreed
        if pending is not None:
            with torch.profiler.record_function("bench.loss_read"):
                losses.append(float(pending))
        pending = loss
        if agree is not None:
            if earlier is None:
                continue
            start, stop = _decided(earlier)
        if stop:
            break
        if start and not sub.active:
            sub.start(n - 1, el)  # step n is in flight
            sub.steps = 1  # and runs inside the sub-window
    hw.sync(prog.device)
    t1 = time.perf_counter()
    losses.append(float(pending))
    return {"seconds": t1 - t0, "steps": n,
            "failed": sum(not math.isfinite(x) for x in losses)}


def _per_rank(world, dev, peak: int, tr) -> list[tuple]:
    """(memory peak, busy seconds, traced span) of every rank."""
    mine = (peak, tr.busy_s if tr else 0.0, tr.span_s if tr else 0.0)
    if world.size == 1:
        return [mine]
    import torch.distributed as dist

    t = torch.tensor(mine, dtype=torch.float64, device=dev)
    got = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(got, t)
    return [tuple(g.tolist()) for g in got]


def execute(cell, seed: int, seconds: float, trace: bool, dev,
            fault: str | None = None, t_start: float = 0.0):
    """One run of a training cell on this rank (`benchmark.kinds`)."""
    from fbanet_tpu_torch.parallel import mesh

    world, dev = mesh.init(dev)
    try:
        prog = Program(cell, seed, dev, world, fault)
        readings = prog.gathered()
        sub = (tracing.SubWindow(f"{cell.name}_r{world.rank}")
               if trace else None)
        hw.sync(dev)
        setup_s = time.perf_counter() - t_start
        peak_setup = hw.peak(dev)
        hw.reset_peak(dev)
        w = window(prog, seconds, sub, _agreement(world, dev))
        tr = sub.stop() if sub is not None and sub.active else None
        peak_window = hw.peak(dev)
        per_rank = _per_rank(world, dev, max(peak_setup, peak_window), tr)
        prog.free()
        if not world.is_main:
            return None
        rec = kinds.record(cell, "train", cell.mix["batch"] // world.size)
        rec.setup_s, rec.window_s = setup_s, w["seconds"]
        rec.units = w["steps"]
        rec.attempted, rec.failed = w["steps"], w["failed"]
        rec.trace = tr
        rec.before_trace = sub.before if sub is not None else None
        rec.peak_bytes = max(p for p, _, _ in per_rank)
        rec.peak_window_bytes = peak_window
        rec.busy_s = [b for _, b, _ in per_rank]
        rec.span_s = [s for _, _, s in per_rank]
        hw.reference_precision()
        ref = reference(cell, seed, dev, world.size)
        rec.numbers = judge.train_numbers(readings, ref)
        return rec
    finally:
        world.close()


def readings(cell, seeds, control_seeds, faults, dev, emit, witness=()):
    """The readings of `benchmark.control` (`benchmark.kinds`): the
    program's checked steps on `seeds`, the control's and each fault's on
    `control_seeds`, and each witness precision's reference on `seeds`."""
    from fbanet_tpu_torch.parallel import mesh

    from benchmark.reference.precision import FP8, PRECISIONS

    world, dev = mesh.init(dev)
    try:
        for seed in sorted(set(seeds) | set(control_seeds)):
            runs = ([None] if seed in seeds else []) + (
                list(faults) if seed in control_seeds else [])
            got = {}
            for fault in runs:
                hw.program_precision()
                prog = Program(cell, seed, dev, world, fault)
                got[fault] = prog.gathered()
                prog.free()
            if not world.is_main:
                continue
            hw.reference_precision()
            ref = reference(cell, seed, dev, world.size)
            for fault, got_readings in got.items():
                where = {}
                emit(seed, fault or "program",
                     judge.train_numbers(got_readings, ref, where), where)
            if seed in control_seeds:
                ctl = reference(cell, seed, dev, world.size, prec=FP8)
                where = {}
                emit(seed, "control", judge.train_numbers(ctl, ref, where),
                     where)
            for prec in witness if seed in seeds else ():
                other = reference(cell, seed, dev, world.size,
                                  prec=PRECISIONS[prec])
                where = {}
                emit(seed, f"reference_{prec}",
                     judge.train_numbers(other, ref, where), where)
            del ref
            hw.empty_cache()
    finally:
        world.close()
