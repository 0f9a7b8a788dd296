"""One run of one cell: set-up, the measured window, the check.

The system under test is `hefl_tpu_torch`. A round is what a user's run
repeats, each from the previous round's decrypted average:

  1. `fl.secure.secure_fedavg_round`: every client trains (fused over the
     clients) and encrypts its weights, the ciphertexts are summed mod p;
     on a cell of several chips each rank trains its block of clients and
     the partial sums are all-reduced mod p;
  2. `fl.secure.decrypt_average`: the owner (rank 0) decrypts the average,
     which `fl.fedavg.replicate_on` hands every rank;
  3. `fl.fedavg.evaluate`: the owner scores the test set.

Set-up makes the inputs on the device from the seed (`inputs`; on several
chips each rank makes only its clients' images), builds the model, the
CKKS context and keys, and runs the first CHECKED_ROUNDS rounds through
the window's own calls: they warm every shape, and the check reads them.
Round 1, which the reference follows, takes its shuffles and affine draws
from `inputs` (the `streams=` argument), so that both sides train on the
same batches; every later round, set-up's second and the window's, draws
them itself from the round's generator, as a user's run does.
The window then starts rounds until `seconds` have passed (rank 0 decides
and tells the others); the round in flight finishes and counts. `round_s`
is the window's wall time on rank 0 over its rounds.

With `trace`, the window is followed by one profiled round (`tracing`) on
every rank, and the per-layer readers (`metrics/<name>.py`) read rank 0's.

After the window (and the peak memory reading) the plain reference
(`reference.train`) trains round 1's clients from the same inputs, float32
without TF32, each rank its own block, and `compare` judges the system's
outputs on rank 0. Last, every rank looks for a forbidden module
(`forbidden_modules`) in its own process, and a run where any rank has
one fails.
"""

from __future__ import annotations

import gc
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch

from benchmark import compare, inputs, yardsticks
from benchmark.manifest import Cell, load, quantity
from benchmark.reference import train as ref_train
from benchmark.reference.models import QUANT, param_spec

CHECKED_ROUNDS = 2
# Calibration runs this many rounds without a window, so that its readings
# of the evaluation cover rounds past the first two, as a run's window does.
CALIBRATION_ROUNDS = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hefl_tpu")
RANK_TIMEOUT_S = 900


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in `sys.modules` that the run must not have loaded,
    compared whole (`hefl_tpu_torch` is not `hefl_tpu`)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    """A rank of the run had loaded a module the benchmark forbids."""


def process_start_time() -> float:
    """The epoch time this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class Rank:
    """This process's place in the run: its device, the client mesh (None
    on one chip), the clients it trains and whether it is the owner."""

    def __init__(self, cell: Cell, device, rank: int = 0, world: int = 1,
                 store: str | None = None):
        self.rank, self.world, self.lead = rank, world, rank == 0
        self.clients = cell.traffic["clients"]
        self.mesh = None
        if world == 1:
            self.device = torch.device(device)
            if self.device.type == "cuda":
                if self.device.index is None:
                    self.device = torch.device("cuda", 0)
                torch.cuda.set_device(self.device)
            self.block = np.arange(self.clients)
            return
        from hefl_tpu_torch.fl.fedavg import client_block
        from hefl_tpu_torch.parallel import init_mesh, make_mesh

        kind = torch.device(device).type
        self.device = init_mesh(kind, backend="nccl" if kind == "cuda" else "gloo",
                                init_method=store, rank=rank, world_size=world)
        self.mesh = make_mesh(self.clients, device=self.device)
        self.block = client_block(self.mesh, self.clients, None)[0]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def gather(self, obj) -> list:
        """Every rank's `obj`, in rank order (one rank: [obj])."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block rows of `t` [cpd, ...], in client order."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def decide(self, stop: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return stop
        import torch.distributed as dist
        flag = torch.tensor([int(stop)], device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


class System:
    """The system under test, built for one cell: its model, training
    configuration, CKKS context and keys."""

    def __init__(self, cell: Cell, weights: dict, seed: int, device):
        from hefl_tpu_torch.ckks.keys import CkksContext, keygen
        from hefl_tpu_torch.ckks.packing import PackSpec
        from hefl_tpu_torch.fl.config import TrainConfig
        from hefl_tpu_torch.models import MedCNN, ResNet20

        cfg, rec = cell.cfg, cell.cfg["recipe"]
        shape = tuple(cfg["input_shape"])
        if cfg["model"] == "medcnn":
            model = MedCNN(cfg["num_classes"], cfg["features"], cfg["dense"], shape)
        else:
            model = ResNet20(cfg["num_classes"], cfg["stage_sizes"], cfg["widths"], shape)
        self.model = model.to(device)
        got = [(k, tuple(v.shape)) for k, v in self.model.named_parameters()]
        want = [(k, s) for k, s, _, _ in param_spec(cfg)]
        if got != want:
            raise ValueError(f"the system's {cfg['model']} parameters {got} are not the "
                             f"configuration's {want}")
        self.params = {k: weights[k].clone() for k, _ in got}
        aug = rec["augment"]
        self.tc = TrainConfig(
            epochs=rec["epochs"], batch_size=rec["batch_size"], lr=rec["lr"],
            lr_decay=rec["lr_decay"], val_fraction=rec["val_fraction"],
            es_patience=rec["es_patience"], plateau_patience=rec["plateau_patience"],
            plateau_factor=rec["plateau_factor"], min_lr=rec["min_lr"],
            min_delta=rec["min_delta"], augment=True, aug_shear=aug["shear"],
            aug_zoom=aug["zoom"], aug_flip=aug["flip"], num_classes=cfg["num_classes"],
            aug_backend=cfg["system"]["aug_backend"],
            client_fusion=cfg["system"]["client_fusion"])
        ck = cfg["ckks"]
        self.ctx = CkksContext.create(n=ck["n"], num_primes=ck["num_primes"],
                                      prime_bits=ck["prime_bits"],
                                      scale=float(2 ** ck["scale_bits"]))
        self.sk, self.pk = keygen(self.ctx, inputs.generator(seed, "keys", 0, "cpu"),
                                  device=device)
        self.pack = PackSpec.for_params(self.params, self.ctx.n)

    def round(self, rk: Rank, params: dict, xs, ys, test, gen, streams=None) -> tuple:
        """One round on this rank -> (new params, metrics float32 [C, E, 4],
        the owner's evaluation or None). Without `streams` the system draws
        the clients' shuffles and affine draws from `gen`."""
        from hefl_tpu_torch.fl import fedavg, secure

        per_client = None
        if streams is not None:
            perms, aug = streams
            per_client = [(perms[c], tuple(a[c] for a in aug))
                          for c in range(int(xs.shape[0]))]
        kw = {} if rk.mesh is None else {"mesh": rk.mesh, "num_real_clients": rk.clients,
                                         "resident_rows": rk.block}
        ct_sum, mets, _ = secure.secure_fedavg_round(
            self.model, self.tc, self.ctx, self.pk, params, xs, ys, gen, streams=per_client,
            **kw)
        res = None
        if rk.lead:
            new = secure.decrypt_average(self.ctx, self.sk, ct_sum, rk.clients, self.pack)
            res = fedavg.evaluate(self.model, new, *test)
        else:
            new = params
        if rk.mesh is not None:
            new = fedavg.replicate_on(rk.mesh, new)
        return new, mets, res


def device_record(rk: Rank, chips: int) -> dict:
    if rk.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(rk.device), "count": chips}


def block_streams(rec, traffic, seed, r, rk: Rank):
    """Round r's streams of this rank's clients."""
    perms, aug = inputs.round_streams(rec, traffic, seed, r, rk.device)
    idx = torch.as_tensor(rk.block, device=rk.device)
    return perms[idx], tuple(a[idx] for a in aug)


def reference_round1(cell: Cell, rk: Rank, weights: dict, xs, ys, seed: int, quant=None,
                     first_batch=None, adam_fault=None) -> dict:
    """The reference's round 1 on this rank's clients, gathered ->
    {"finals": every client's trained weights [C, P], "loss1": validation
    losses [C, E], "grad1": first-step gradients [C, P]}."""
    cfg, rec = cell.cfg, cell.cfg["recipe"]
    st = block_streams(rec, cell.traffic, seed, 0, rk)
    with ref_train.float32_exact():
        finals, rows, first = ref_train.train_clients(
            cfg, rec, ref_train.flatten(cfg, weights), xs, ys, st, quant=QUANT.get(quant),
            first_batch=first_batch, adam_fault=adam_fault)
    return {"finals": rk.gather_rows(finals), "grad1": rk.gather_rows(first),
            "loss1": np.concatenate(rk.gather(rows[:, :, 0]))}


def _setup(cell: Cell, rk: Rank, seed: int, log):
    cfg = cell.cfg
    xs, ys, xt, yt = inputs.federated(cfg, cell.traffic, seed, rk.device,
                                      clients=rk.block.tolist())
    test = (xt, yt.cpu().numpy()) if rk.lead else None
    weights = inputs.initial_weights(param_spec(cfg), seed, rk.device)
    system = System(cell, weights, seed, rk.device)
    if rk.lead:
        log(f"{cell.name}: {rk.clients} clients ({len(rk.block)} on each of {rk.world} "
            f"rank(s)) x {int(xs.shape[1])} images {tuple(xs.shape[2:])}, "
            f"{sum(v.numel() for v in weights.values())} parameters, n_ct {system.pack.n_ct}")
    return xs, ys, (xt, yt), test, weights, system


def _checked_rounds(cell, rk, system, xs, ys, test, seed, log, rounds=CHECKED_ROUNDS):
    """Set-up's rounds -> (params after them, what the check reads). Round
    1 trains on the shuffles and draws of `inputs`, which the reference is
    handed too; the later ones draw their own, as the window's do. In
    round 1 the harness reads, as the system's calls return them, the
    clients' Adam state after their first step (`fl.fusion.fused_step`;
    its first moment over 1 - beta1 is the first gradient) and the weights
    they upload (`fl.secure.train_block`), for the check. Neither read
    changes what the calls compute."""
    from hefl_tpu_torch.fl import fusion, secure

    cfg, rec = cell.cfg, cell.cfg["recipe"]
    names = [name for name, _, _, _ in param_spec(cfg)]
    params = system.params
    seen = {"p0": ref_train.flatten(cfg, params), "acc": [], "flat": [], "grad1": [],
            "uploads": []}
    fused_step, train_block = fusion.fused_step, secure.train_block

    def read_first_step(*args, **kwargs):
        new_params, opt = fused_step(*args, **kwargs)
        if not seen["grad1"]:
            seen["grad1"].append(torch.cat([opt.mu[k].reshape(opt.mu[k].shape[0], -1)
                                            for k in names], dim=1) / (1 - 0.9))
        return new_params, opt

    def read_uploads(*args, **kwargs):
        p_out, mets = train_block(*args, **kwargs)
        seen["uploads"].append(torch.stack([ref_train.flatten(cfg, p) for p in p_out]))
        return p_out, mets

    for r in range(rounds):
        t = time.perf_counter()
        if r == 0:
            fusion.fused_step, secure.train_block = read_first_step, read_uploads
        try:
            params, mets, res = system.round(
                rk, params, xs, ys, test, inputs.generator(seed, "keys", 1 + r, "cpu"),
                block_streams(rec, cell.traffic, seed, r, rk) if r == 0 else None)
        finally:
            fusion.fused_step, secure.train_block = fused_step, train_block
        rk.sync()
        seen["flat"].append(ref_train.flatten(cfg, params))
        if r == 0:
            seen["loss1"] = mets[:, :, 0].cpu().numpy()
        if rk.lead:
            seen["acc"].append(float(res["accuracy"]))
            log(f"set-up round {r}: {time.perf_counter() - t:.3f} s, accuracy "
                f"{res['accuracy']:.4f}")
    if len(seen["grad1"]) != 1 or len(seen["uploads"]) != 1:
        raise RuntimeError("the check could not read round 1's first step and uploads "
                           "(fl.fusion.fused_step, fl.secure.train_block)")
    seen["p1"] = seen["flat"][0]
    seen["grad1"] = rk.gather_rows(seen["grad1"][0])[: rk.clients]
    uploads = rk.gather_rows(seen.pop("uploads")[0])[: rk.clients]
    seen["agg_ref"] = uploads.mean(dim=0)
    seen["uploads"] = uploads
    return params, seen


def _judge(cell, rk, weights, xs, ys, test_dev, seen, seed, log):
    """The reference's round 1 and the numbers -> (values on rank 0, or
    None on the others; the reference's round 1)."""
    cfg = cell.cfg
    t = time.perf_counter()
    ref = reference_round1(cell, rk, weights, xs, ys, seed)
    if not rk.lead:
        return None, ref
    xt, yt = test_dev
    ref["acc_of_sys"] = [ref_train.evaluate(cfg, f, xt, yt) for f in seen["flat"]]
    values = compare.numbers(cfg, seen, ref, int(xt.shape[0]))
    log(f"reference: {time.perf_counter() - t:.3f} s")
    return values, ref


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rank_run(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, rank: int = 0, world: int = 1, store: str | None = None,
             log=None) -> dict | None:
    """This rank's part of one run -> the result dict on rank 0 (the keys of
    the result line, "checks" last), None on the others."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = Cell(root, load(root), workload)
    traffic = cell.traffic
    rk = Rank(cell, device, rank, world, store)
    if rk.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rk.device)
    xs, ys, test_dev, test, weights, system = _setup(cell, rk, seed, log)
    params, seen = _checked_rounds(cell, rk, system, xs, ys, test, seed, log)
    setup_s = time.time() - t_start

    def one_round(p, r):
        return system.round(rk, p, xs, ys, test, inputs.generator(seed, "keys", 1 + r, "cpu"))

    # Every round's decrypted weights and reported accuracy are kept (by
    # reference, no copy), so the check scores each evaluation of the run.
    answers = []
    r = CHECKED_ROUNDS
    t0 = time.perf_counter()
    while True:
        params, _, res = one_round(params, r)
        rk.sync()
        if rk.lead:
            answers.append((params, res["accuracy"]))
        r += 1
        if rk.decide(time.perf_counter() - t0 >= seconds):
            break
    wall = time.perf_counter() - t0
    rounds = r - CHECKED_ROUNDS
    round_s = wall / rounds
    if rk.lead:
        log(f"window: {rounds} rounds in {wall:.3f} s, round_s {round_s:.6f}")

    metrics, breakdown, dev = {}, None, device_record(rk, cell.chips)
    if trace:
        from benchmark import tracing
        path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
        with tracing.profiled(path, rk.device):
            with torch.profiler.record_function(tracing.ROUND):
                one_round(params, r)
                rk.sync()
        try:
            rt = tracing.read_round_trace(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        spans = rk.gather((rt.busy_us() / 1e6, (rt.window[1] - rt.window[0]) / 1e6))
        if rk.lead:
            view = types.SimpleNamespace(
                trace=rt, round_s=round_s, chips=cell.chips, cfg=cell.cfg, traffic=traffic,
                train_flops=yardsticks.train_flops(cell.cfg, cell.cfg["recipe"], traffic),
                he_bytes=yardsticks.he_bytes(cell.cfg["ckks"], cell.cfg["params"],
                                             len(rk.block)))
            for m in cell.per_layer():
                v = cell.reader(m["name"])(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev["busy_s"] = float(np.mean([s[0] for s in spans]))
            dev["window_s"] = float(np.mean([s[1] for s in spans]))
            breakdown = rt.breakdown()
            log(f"trace: busy {dev['busy_s']:.6f} s of {dev['window_s']:.6f} s, "
                f"{len(rt.ops)} device ops, {rt.dropped} dropped launches, "
                f"{rt.unlinked} unlinked")
    else:
        e2e = {"round_s": round_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[quantity(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    peak = (int(torch.cuda.max_memory_allocated(rk.device)) if rk.device.type == "cuda"
            else 0)
    dev["memory_peak_bytes"] = max(rk.gather(peak))

    seen["flat"] += [ref_train.flatten(cell.cfg, p) for p, _ in answers]
    seen["acc"] += [float(a) for _, a in answers]
    del system, params, answers
    _free(rk.device)
    values, _ = _judge(cell, rk, weights, xs, ys, test_dev, seen, seed, log)
    found = {r: bad for r, bad in enumerate(rk.gather(forbidden_modules())) if bad}
    if found:
        raise ForbiddenModules(f"forbidden modules loaded, by rank: {found}")
    if not rk.lead:
        return None
    log("numbers: " + " ".join(f"{k}={v!r}" for k, v in values.items()))
    if cell.limits is None:
        ok, checks = False, {k: {"value": v, "limit": None} for k, v in values.items()}
        log(f"no limits file for {workload}: not correct")
    else:
        ok, checks = compare.judge(values, cell.limits)
    out = {"correct": bool(ok), "attempted": rounds, "failed": 0, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def calibration(root: str, workload: str, seeds: list, device, rank: int = 0,
                world: int = 1, store: str | None = None, control: int = 0,
                faults: int = 0, log=None) -> list | None:
    """Readings for the limits, no window: for each seed the system's
    checked rounds against the reference (the lower readings); on the
    first `control` seeds the controls, each in the system's place: the
    reference's training with float8 operands, outputs and gradients (one
    precision below the configuration's bfloat16), and the plain mean of
    the uploads in bfloat16 (one below the float32 weights the owner
    decodes); on the first `faults` seeds the planted faults, in the
    reference put in the system's place: half the clients averaged (the
    mean over the rest), the state unchanged, and on several ranks the
    exchange between them left out; and, for the first gradient, the first
    step's loss taken over half its batch, and for the evaluation its
    answers altered (each image scored against another image's label).
    -> the readings on rank 0."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = Cell(root, load(root), workload)
    cfg = cell.cfg
    rk = Rank(cell, device, rank, world, store)
    out = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        xs, ys, test_dev, test, weights, system = _setup(cell, rk, seed, log)
        _, seen = _checked_rounds(cell, rk, system, xs, ys, test, seed, log,
                                  rounds=CALIBRATION_ROUNDS)
        t_sys = time.perf_counter() - t
        del system
        _free(rk.device)
        t = time.perf_counter()
        values, ref = _judge(cell, rk, weights, xs, ys, test_dev, seen, seed, log)
        t_ref = time.perf_counter() - t
        if rk.lead:
            out.append({"kind": "system", "seed": seed, **values, "system_s": t_sys,
                        "reference_s": t_ref, "acc": seen["acc"],
                        "grad1_worst_leaf": compare.worst_leaf(cfg, seen["grad1"], ref["grad1"]),
                        "update1_worst_leaf": compare.worst_leaf(
                            cfg, seen["p1"] - seen["p0"], ref["finals"].mean(dim=0) - seen["p0"])})
            log(str(out[-1]))
        planted = []          # (kind, what replaces the system's readings)
        if i < control:
            c = reference_round1(cell, rk, weights, xs, ys, seed, "fp8")
            planted.append(("control_fp8", {"p1": c["finals"].mean(dim=0),
                                            "agg_ref": c["finals"].mean(dim=0),
                                            "grad1": c["grad1"], "loss1": c["loss1"],
                                            "eval_quant": "fp8"}))
            # the aggregation's control: the plain mean of the uploads in bfloat16
            bf = seen["uploads"].to(torch.bfloat16).mean(dim=0).to(torch.float32)
            planted.append(("control_agg_bf16", {"p1": bf}))
        if i < faults:
            ups = seen["uploads"]
            planted.append(("fault_half_clients", {"p1": ups[: rk.clients // 2].mean(dim=0)}))
            planted.append(("fault_unchanged", {"p1": seen["p0"], "agg_ref": seen["p0"]}))
            hb = reference_round1(cell, rk, weights, xs, ys, seed,
                                  first_batch=cell.cfg["recipe"]["batch_size"] // 2)
            planted.append(("fault_half_batch", {"grad1": hb["grad1"]}))
            planted.append(("fault_answers_altered", {"shuffle_labels": True}))
            if rk.world > 1:
                own = ups[: len(rk.block)].sum(dim=0) / rk.clients
                planted.append(("fault_no_exchange", {"p1": own}))
        if not rk.lead:
            continue
        xt, yt = test_dev
        for kind, alt in planted:
            got = dict(seen, flat=[alt.get("p1", seen["p1"])] + seen["flat"][1:], **alt)
            if "p1" in alt:
                got["acc"] = [ref_train.evaluate(cfg, got["p1"], xt, yt,
                                                 quant=QUANT.get(alt.get("eval_quant")))]
            if alt.get("shuffle_labels"):      # each image scored against another's label
                perm = torch.randperm(int(yt.shape[0]),
                                      generator=inputs.generator(seed, "test", 1, "cpu"))
                got["acc"] = [ref_train.evaluate(cfg, f, xt, yt[perm.to(yt.device)])
                              for f in seen["flat"]]
            acc_of = dict(ref, acc_of_sys=[ref_train.evaluate(cfg, f, xt, yt)
                                           for f in got["flat"][: len(got["acc"])]])
            out.append({"kind": kind, "seed": seed,
                        **compare.numbers(cfg, got, acc_of, int(xt.shape[0]))})
            log(str(out[-1]))
    return out if rk.lead else None


ADAM_FAULTS = ("lr_x1.5", "no_bias_correction")


def adam_fault_readings(root: str, workload: str, seeds: list, device, log=None) -> list:
    """Readings of faults in Adam at the cell's size, on one device: for
    each seed and each of ADAM_FAULTS, the reference with that fault, put
    in the system's place, against the sound reference. The fault stands
    in for everything the training stage reads, so the system itself does
    not run. -> one row a seed and fault."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = Cell(root, load(root), workload)
    cfg = cell.cfg
    rk = Rank(cell, device)
    out = []
    for seed in seeds:
        xs, ys, _, _ = inputs.federated(cfg, cell.traffic, seed, rk.device,
                                        clients=rk.block.tolist())
        weights = inputs.initial_weights(param_spec(cfg), seed, rk.device)
        p0 = ref_train.flatten(cfg, weights)
        ref = reference_round1(cell, rk, weights, xs, ys, seed)
        d_ref = ref["finals"].mean(dim=0) - p0
        for fault in ADAM_FAULTS:
            t = time.perf_counter()
            bad = reference_round1(cell, rk, weights, xs, ys, seed, adam_fault=fault)
            d_bad = bad["finals"].mean(dim=0) - p0
            gaps = compare.leaf_gaps(cfg, d_bad, d_ref)
            out.append({"kind": "fault_adam_" + fault, "seed": seed,
                        "update1_gap": float(np.max(gaps)),
                        "update1_median_gap": float(np.median(gaps)),
                        "update1_worst_leaf": compare.worst_leaf(cfg, d_bad, d_ref),
                        "grad1_median_gap": float(np.median(
                            compare.leaf_gaps(cfg, bad["grad1"], ref["grad1"]))),
                        "reference_s": time.perf_counter() - t})
            log(str(out[-1]))
        del xs, ys, ref
        _free(rk.device)
    return out


# ---------------------------------------------------------------- ranks


def _rank_entry(fn, rank: int, world: int, store: str, args: tuple, kwargs: dict,
                results) -> None:
    """A spawned rank: run `fn` and put (rank, ok, value) on `results`."""
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(2)
        value = fn(*args, rank=rank, world=world, store=store, **kwargs)
        results.put((rank, True, value))
    except Exception:  # the parent raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def on_ranks(fn, world: int, *args, **kwargs):
    """`fn(*args, rank=, world=, store=, **kwargs)` (a module-level
    function) in `world` spawned processes, one a device, joined through a
    file store under $TMPDIR -> rank 0's value. Every rank is waited for;
    one that fails raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bench_store_")
    store = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, store, args, kwargs, results))
             for r in range(world)]
    got, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(got) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if not p.is_alive() and r not in got]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks {sorted(set(range(world)) - set(got))} gave no "
                                  f"result (dead: {dead})")
                    break
                continue
            got[rank] = value
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(30)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return got[0]


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float | None = None, log=None) -> dict:
    """One run of `workload` on `device` ("cuda" or "cpu"; a cell of
    several chips spawns one rank a device) -> rank 0's result."""
    t_start = process_start_time() if t_start is None else t_start
    chips = Cell(root, load(root), workload).chips
    if chips == 1:
        return rank_run(root, workload, seed, seconds, trace, device, t_start, log=log)
    return on_ranks(rank_run, chips, root, workload, seed, seconds, trace,
                    torch.device(device).type, t_start)
