"""One run of one cell: write the inputs, bring the training run up through
the program's own entry point, train through the check's steps and the
warm-up, time the window, check the first steps against the reference,
and return the result.

The run is the CLI's: ``ctc_tpu_torch.cli.main.run`` builds the dataset
(``get_dataset``), the model (``build_model``), the ``Trainer`` with the
CLI's defaults and ``init_state``, and calls ``Trainer.fit``, which this
module stands in for while the run lasts: it loads the benchmark's
initial weights into the model, then calls ``Trainer.train_epoch`` over
the cell's loader epoch after epoch.  The loader is clocked
(:class:`benchmark.feeds.Clocked`); its steps, in order, are:

1. ``check_steps`` steps whose batches, losses, first-step optimizer state
   and final parameters are kept for the check;
2. ``warmup_steps`` more;
3. the timed window, from the end of the last warm-up step to the end of
   the first step that finishes ``seconds`` after it;
4. with ``trace``, ``profile_steps`` more under ``torch.profiler``.

``setup_s`` runs from the end of writing the inputs to the window's
start.  The reference runs once the window has closed, the peak memory has
been read and the program's state has been let go.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from benchmark import corpus, spec
from benchmark.feeds import Clocked, Resident, Stop

FORBIDDEN = ("jax", "jaxlib", "flax", "ctc_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_dir(cell_name: str) -> str:
    """The run's own files (the trainer's logs and window cache)."""
    return os.path.join(tempfile.gettempdir(), "ctc_bench", cell_name)


def corpus_dir(cell: dict) -> str:
    """Where the cell's corpus is kept between runs, inside the checkout:
    one tree for each corpus size and kind of frames."""
    geom = cell["config"]["geometry"]
    frames = "empty" if cell["feed"] == "features" else "jpeg"
    name = (f"{frames}-{cell['train_videos']}-{cell['val_videos']}-"
            f"{geom['temporal']}-{geom['gap']}-{geom['num_trans']}")
    return str(spec.ROOT / "build" / "benchmark-corpus" / name)


def write_inputs(cell: dict, seed: int, root: str, corpus_root=None) -> dict:
    shutil.rmtree(root, ignore_errors=True)
    geom = cell["config"]["geometry"]
    return corpus.write_corpus(
        corpus_root or corpus_dir(cell), seed=seed,
        train_videos=cell["train_videos"], val_videos=cell["val_videos"],
        feat_dim=cell["config"]["feature_dim"],
        jpeg=cell["feed"] != "features", features=cell["feed"] == "features",
        temporal=geom["temporal"], gap=geom["gap"],
        num_trans=geom["num_trans"])


def cli_argv(cell: dict, paths: dict, seed: int, device: str, root: str):
    conf = cell["config"]
    geom = conf["geometry"]
    argv = [
        "--dataset", conf["dataset"],
        "--temporal", str(geom["temporal"]), "--gap", str(geom["gap"]),
        "--num-trans", str(geom["num_trans"]),
        "--batch-size", str(cell["batch_size"]),
        "--loss", conf["loss"], "--v-class", str(conf["hidden"]),
        "--inputsize", str(conf["inputsize"]),
        "--extract-feat-dim", str(conf["feature_dim"]),
        "--rgb-data", paths["rgb_data"],
        "--train-file", paths["train_file"], "--val-file", paths["val_file"],
        "--cache-dir", os.path.join(root, "cache"), "--name", "run",
        "--manual-seed", str(seed & 0xFFFFFFFF), "--device", device,
        *(f for key, value in conf["recipe"].items()
          for f in (f"--{key.replace('_', '-')}", str(value))),
    ]
    if cell["finetune"]:
        argv.append("--finetune-i3d")
    if cell["feed"] == "features":
        argv += ["--features-dir", paths["features_dir"]]
    return argv + list(conf.get("flags", []))


class Run:
    """What one run records as it goes."""

    def __init__(self, cell, seed, seconds, trace, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.model = spec.model(cell["config"])
        self.check = {"losses": []}
        self.record = {}
        self.marks = {}
        self.window = None

    # -- the steps ---------------------------------------------------------

    def fit(self, trainer, train_loader, state):
        import torch

        from ctc_tpu_torch.train.graphs import to_device

        self.marks["built"] = time.perf_counter()
        self.load_weights(state.model)
        n_check = self.cell["check_steps"]
        loader = train_loader
        if self.cell["feed"] == "resident":
            loader = Resident(train_loader, n_check, to_device,
                              trainer.device)
        first_window = n_check + self.cell["warmup_steps"]
        profile_steps = self.cell["profile_steps"] if self.trace else 0
        sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
                else (lambda: None))
        self.named = self.trained_names(state)
        timers = (Timers(state.model, self.model.TIMED, self.device)
                  if self.trace else None)
        orig_step = trainer.train_step
        losses = self.check["losses"]

        def recording_step(st, batch, generator=None):
            st, m = orig_step(st, batch, generator)
            losses.append(m["loss"].detach().clone())
            return st, m

        trainer.train_step = recording_step
        prof = {}

        def on_step_end(step, now):
            if step == 0:
                self.check["grad1"] = self.optimizer_gradient(state)
            if step == n_check - 1:
                self.marks["checked"] = now
                trainer.train_step = orig_step
                self.check["params"] = {
                    ref: p.detach().cpu().clone()
                    for ref, p in self.named.items()}
            if step == first_window - 1:
                self.window = [now, None, step + 1]
                if timers:
                    timers.arm()
            elif self.window and self.window[1] is None \
                    and now - self.window[0] >= self.seconds:
                self.window[1] = now
                self.window_steps = step + 1 - self.window[2]
                if timers:
                    timers.disarm()
                if not profile_steps:
                    raise Stop
                from benchmark import trace as trace_lib

                # the profiler warms up over one step, then records
                prof["p"] = trace_lib.start(profile_steps)
                prof["step"] = step + 1
            elif "p" in prof:
                if step - prof["step"] == profile_steps:
                    sync()
                    prof["stop"] = time.perf_counter()
                    prof["p"].step()
                    raise Stop
                prof["p"].step()
                if step == prof["step"]:
                    prof["start"] = time.perf_counter()

        feed = Clocked(loader, on_step_end, keep=n_check, span=(
            (lambda: torch.profiler.record_function("benchmark: data wait"))
            if self.trace else None))
        epoch = 0
        while not feed.stopped:
            state, _ = trainer.train_epoch(state, feed, epoch)
            epoch += 1
        self.feed = feed
        if prof:
            from benchmark import trace as trace_lib

            self.record["profile"] = trace_lib.reduce(
                prof["p"], profile_steps, prof["stop"] - prof["start"])
            prof.clear()
        if timers:
            self.record.update(timers.read())
        if self.device == "cuda":
            self.record["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated())
        self.named = None
        return state, []

    def load_weights(self, model):
        """The benchmark's initial weights, in the program's names."""
        import torch

        from benchmark.reference import train as ref_train

        self.weights = ref_train.initial_weights(
            self.model, self.model.shapes(self.cell["config"]), self.seed,
            self.device)
        current = model.state_dict()
        new = {}
        for name, t in current.items():
            ref = self.model.ref_name(name)
            if ref in self.weights:
                new[name] = self.weights[ref]
            elif name.endswith("num_batches_tracked"):
                new[name] = torch.zeros_like(t)
            else:
                raise KeyError(f"no initial weight for {name}")
        model.load_state_dict(new)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}

    def trained_names(self, state):
        return {self.model.ref_name(n): p
                for n, p in state.model.named_parameters()
                if p.requires_grad}

    def optimizer_gradient(self, state):
        """Each trained leaf's first gradient as the optimizer holds it
        after one update: Adam's first moment over ``1 - beta1``, or the
        SGD momentum trace."""
        opt = state.optimizer
        by_id = {id(p): opt.exp_avg[i] / (1 - opt.betas[0])
                 for i, p in enumerate(opt.params)}
        if opt.sgd is not None:
            by_id.update({id(p): opt.sgd.trace[i]
                          for i, p in enumerate(opt.sgd.params)})
        return {ref: by_id[id(p)].detach().cpu().clone()
                for ref, p in self.named.items()}


class Timers:
    """The traced run's device clock around the forward of the program
    model's attribute ``timed`` (the configuration's ``TIMED``; nothing
    where None): CUDA events at its boundary, armed for the window."""

    def __init__(self, model, timed, device):
        import torch

        self.armed = False
        self.events = []
        self.handles = []
        backbone = getattr(model, timed) if timed else None
        if backbone is not None and device == "cuda":
            def before(module, args):
                if self.armed:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.events.append([ev, None])

            def after(module, args, out):
                if self.armed and self.events and self.events[-1][1] is None:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.events[-1][1] = ev

            self.handles = [backbone.register_forward_pre_hook(before),
                            backbone.register_forward_hook(after)]

    def arm(self):
        self.armed = True

    def disarm(self):
        self.armed = False

    def read(self) -> dict:
        import torch

        for h in self.handles:
            h.remove()
        if self.events:
            torch.cuda.synchronize()
        return {"backbone_forward_s": [
            a.elapsed_time(b) * 1e-3 for a, b in self.events
            if b is not None]}


def reference_batches(cell: dict, paths: dict, seed: int, steps: int):
    """The first ``steps`` train batches as the reference works them out
    from the corpus files: ``feats``, ``paths``, ``target_lengths`` and
    ``future_target`` as numpy arrays."""
    from benchmark.reference import data as ref_data

    conf = cell["config"]
    geom = conf["geometry"]
    offsets = spec.model(conf).clip_offsets(conf)
    labels = ref_data.parse_csv(paths["train_file"])
    counts = {v: ref_data.count_frames(paths["rgb_data"], v) for v in labels}
    windows = ref_data.train_windows(labels, counts, paths["rgb_data"],
                                     temporal=geom["temporal"],
                                     gap=geom["gap"],
                                     num_trans=geom["num_trans"])
    index = ref_data.train_batches(len(windows), cell["batch_size"],
                                   seed & 0xFFFFFFFF)
    feats = None
    if offsets is None:
        feats = np.load(os.path.join(paths["features_dir"],
                                     "features_train.npy"), mmap_mode="r")
    out = []
    for idx in index[:steps]:
        want = {
            "paths": np.stack([windows[i]["path"] for i in idx]),
            "target_lengths": np.array([windows[i]["length"] for i in idx]),
            "future_target": np.array([windows[i]["future"] for i in idx]),
        }
        if offsets is not None:
            want["feats"] = np.stack([
                ref_data.window_clips(windows[i]["frames"], offsets,
                                      conf["inputsize"]) for i in idx])
        else:
            want["feats"] = np.asarray(feats[idx], np.float32)
        out.append(want)
    return out


def batch_gaps(got: dict, want: dict, temporal: int) -> tuple[int, float]:
    """``(target entries that differ, largest input gap)`` of a program's
    batch against the reference's."""
    import torch

    got = {k: np.asarray(torch.as_tensor(v).cpu()) for k, v in got.items()}
    mismatched = sum(int(np.sum(got[k].astype(np.int64) != want[k]))
                     for k in ("paths", "target_lengths", "future_target"))
    mismatched += int(np.sum(got["input_lengths"] != temporal))
    return mismatched, float(np.max(np.abs(got["feats"] - want["feats"])))


def reference_steps(cell, batches, weights, seed, device, tf32=False):
    """:func:`benchmark.reference.train.train_steps` of the cell's model
    over ``batches`` from ``weights`` (both moved to ``device``)."""
    import torch

    from benchmark.reference import train as ref_train

    on = [{k: torch.as_tensor(b[k]).to(device)
           for k in ("feats", "paths", "target_lengths")} for b in batches]
    return ref_train.train_steps(
        spec.model(cell["config"]),
        {k: v.to(device) for k, v in weights.items()}, on,
        finetune=cell["finetune"], seed=seed & 0xFFFFFFFF, tf32=tf32,
        **cell["config"]["recipe"])


def _numbers(run: Run, paths: dict) -> dict:
    """The check: the program's batches against the reference's, then the
    first steps' losses, first gradient and change against the reference's
    steps from the same weights."""
    from benchmark.reference import train as ref_train

    cell = run.cell
    wanted = reference_batches(cell, paths, run.seed, len(run.feed.batches))
    mismatched, input_gap = 0, 0.0
    for got, want in zip(run.feed.batches, wanted):
        m, g = batch_gaps(got, want, cell["config"]["geometry"]["temporal"])
        mismatched, input_gap = mismatched + m, max(input_gap, g)
    run.feed = None
    reference = reference_steps(cell, wanted, run.weights, run.seed,
                                run.device)
    program = {"losses": [float(x) for x in run.check["losses"]],
               "grad1": run.check["grad1"], "params": run.check["params"]}
    out = ref_train.compare(program, reference, run.weights)
    print(f"losses: program {program['losses']}, reference "
          f"{reference['losses']}", file=sys.stderr)
    print("numbers: " + json.dumps(
        {k: v for k, v in out.items() if k != "still_leaves"}),
        file=sys.stderr)
    out["batch_mismatches"] = mismatched
    out["input_gap"] = input_gap
    return out


class NoCard(Exception):
    """The machine lacks the cards the cell asks for."""


def check_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} present")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root_dir=None, cell=None,
             corpus_root=None) -> dict:
    """One run of cell ``name``; returns the result line's object.  On
    ``cuda`` it raises :class:`NoCard` where the cards are missing."""
    t_start = time.perf_counter()
    cell = cell or spec.cell(name)
    root = root_dir or run_dir(name)
    paths = write_inputs(cell, seed, root,
                         corpus_root or (root_dir and os.path.join(
                             root_dir, "corpus")))
    t_inputs = time.perf_counter()
    print(f"inputs: {paths['seconds']:.3f} s, {paths['bytes']} bytes, "
          f"windows {paths['windows']}", file=sys.stderr)
    try:
        return _run(cell, seed, seconds, trace, device, root, paths,
                    t_start, t_inputs)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, root, paths, t_start,
         t_inputs) -> dict:
    import torch

    if device == "cuda":
        check_cards(torch, cell["chips"])
        print(f"card: {_card_line()}; host cores (os.cpu_count(), the "
              f"JPEG decode's threads): {os.cpu_count()}", file=sys.stderr)

    from ctc_tpu_torch import config as config_lib
    from ctc_tpu_torch.cli import main as cli_main
    from ctc_tpu_torch.train import trainer as trainer_mod

    run = Run(cell, seed, seconds, trace, device)
    run.marks["imported"] = time.perf_counter()
    cfg = config_lib.parse(cli_argv(cell, paths, seed, device, root))
    fit = trainer_mod.Trainer.fit
    trainer_mod.Trainer.fit = (
        lambda self, train_loader, val_loader, *, state, **_:
        run.fit(self, train_loader, state))
    try:
        with contextlib.redirect_stdout(sys.stderr):
            cli_main.run(cfg, torch.device(device))
    finally:
        trainer_mod.Trainer.fit = fit
    feed = run.feed
    t0, t1, first = run.window
    steps = run.window_steps
    times = np.diff([t0] + feed.ends[first:first + steps])
    windows = sum(feed.rows[first:first + steps])
    record = {**run.record, "window_s": t1 - t0, "window_steps": steps,
              "window_rows": windows,
              "data_wait_s": feed.waits[first:first + steps],
              "cell": cell, "device_name": _device_name(torch, device)}
    feed.loader = None
    del feed
    peak = run.record.get("memory_peak_bytes", 0)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "train_windows_per_s": lambda: windows / (t1 - t0),
            "step_ms_p95": lambda: 1e3 * (statistics.quantiles(
                times, n=20, method="inclusive")[-1] if len(times) > 1
                else times[0]),
            "setup_s": lambda: t0 - t_inputs,
        }
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]](),
                                  "unit": m["unit"]}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = _numbers(run, paths)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct, "attempted": steps, "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": record["device_name"], "count": cell["chips"],
                   "memory_peak_bytes": peak},
    }
    if trace and "profile" in record:
        prof = record["profile"]
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = prof["breakdown"]
    print(f"window: {steps} steps, {windows} windows, {t1 - t0:.3f} s; "
          f"setup {t0 - t_inputs:.3f} s; run {time.perf_counter() - t_start:.1f} s;"
          f" leaves: grad {numbers['grad_leaf']}, change "
          f"{numbers['change_leaf']}; still {numbers['still_leaves']}",
          file=sys.stderr)
    marks = [t_inputs] + [run.marks[k] for k in ("imported", "built",
                                                 "checked")] + [t0]
    print("setup: " + ", ".join(
        f"{k} {b - a:.3f} s" for k, a, b in zip(
            ("imports", "dataset and model", "weights and check steps",
             "warm-up"), marks, marks[1:])), file=sys.stderr)
    result["checks"] = checks
    return result


def _card_line() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _device_name(torch, device):
    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"
