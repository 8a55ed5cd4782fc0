"""The training engine (port of train/learner.py).

The same epoch protocol as the JAX learner: adapt lr and beta1 -> train
pass -> validation pass -> on a new validation minimum save ``.model``,
``.optim`` and ``.json`` (the resume snapshot) -> the visual grid every 50
epochs and on an optimum -> the loss-curve plot from epoch 1 -> the final
model.  File
names ``<base><FNB_MARKS><suffix>.{model,optim,json,png}``; checkpoints in
the JAX package's formats, so a run can resume in either package.

Data on the device: each loader's cases are stacked on the device once, and
each batch is gathered there by row index in the order that the loader's
numpy RNG gives.  A step is forward, loss, backward, Adam; the per-step
metrics stay on the device until one fetch at the end of the epoch phase.

The device plan (``device_cache``; ``None`` reads ``STROKE_TPU_DEVICE_CACHE``,
default ``"1"``, ``"0"`` off, as the JAX learner does): at its first pass a
loader draws every remaining epoch's chunks (one ``epoch_chunks()`` an
epoch, in order: the RNG stream of the eager loop) and the learner puts
their rows on the device, ``PLAN_BLOCK`` epochs to a tensor, each row
vector followed by the step's slot in the pass; consecutive chunks of one
size form a group (the JAX learner's ``_make_plan``).  On the card each
(phase, group) step is captured into a CUDA graph after its first step,
which runs eagerly and counts as a step (it builds the kernels and lets
cuDNN choose); the graph reads its plan vector at a device cursor in a
static buffer, into which the host copies a whole plan block, and moves
the cursor on, so that a step is one replay; each step writes its metrics
into the pass's row of one device buffer (one fetch a pass).  Every value
that changes between steps is device state the graph reads: the learning
rate and betas (``train.optim.Adam``, set in place), the loss factor
(filled once a pass) and the learner's generator, registered with every
graph so that each replay draws on from its state, the numbers the eager
loop draws.  All graphs share one memory pool.  On the CPU the plan path runs
the same step body eagerly.  A ``process_shard`` loader or a mesh of more
than one rank (``--distributed``, ``--ndevices``, H sharding) keeps the
eager loop; so does ``device_cache=False``.  A capture that fails raises.
``STROKE_TPU_TIME_EPOCH=1`` prints ``[epoch-probe] train|eval dispatch
... ms fetch ... ms`` for each planned pass.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` of one process per
card), as the JAX learner runs it on a ``data`` mesh: each step is the
one-process step on the global batch.  Every rank draws the same epoch
order and random crops from the shared seed and takes its rows of each
chunk by the row rule (``parallel.mesh.row_sharding``): a chunk that
divides over the ranks is sharded, and its BN moments, Dice sums, measures
and gradients are reduced over them (``parallel/collectives.py``); any
other chunk runs whole on every rank, with no collective.  A loader with
``process_shard`` (``--distributed``) takes the host path instead: each
process stacks only its share of a chunk on the host, and
``data.prefetch`` stages the next one on the card while a step runs.  Only
the lead process (rank 0) writes checkpoints, curves and PNGs and prints
the epoch and momentum lines; every rank loads a snapshot to resume.

Each training pass is timed from its start to that fetch
(``utils.profiling.StepTimer`` over the mesh's chips, the first pass left
out as warm-up, the global batch counted), and ``log_throughput`` prints
``[throughput] ... volumes/sec/chip`` before the epoch line.  Each step
runs in an ``annotate("train_step")`` / ``"eval_step"`` range, and
``profile_dir`` traces the second training pass (or the only one) with
``torch.profiler`` into that directory.

PNGs need matplotlib, imported when first needed; without it the learner
prints one line and writes no PNGs.  Nothing else depends on it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.data.prefetch import (
    DevicePut, prefetch_to_device)
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.convert import (
    adam_state_from_jax, adam_state_to_jax)
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, row_sharding)
from stroke_prediction_tpu_torch.train.optim import (
    beta1_ramp, set_beta1, set_learning_rate)
from stroke_prediction_tpu_torch.utils import checkpoint as ckpt
from stroke_prediction_tpu_torch.utils.profiling import (
    StepTimer, annotate, prepare_graph_trace, trace)


class Learner:
    """Base class with the standard training routine."""

    FNB_MARKS = "_learner"
    FN_VIS_BASE = "_visual_"
    EXT_MODEL = ".model"
    EXT_OPTIM = ".optim"
    EXT_TRAIN = ".json"
    EXT_IMAGE = ".png"

    N_EPOCHS_ADAPT_BETA1: Optional[int] = None    # set by the CAE learners
    PLAN_BLOCK = 8          # epochs of the device plan to a row tensor

    def __init__(self, dataloader_training, dataloader_validation, model,
                 optimizer, lr_schedule, n_epochs: int,
                 path_previous_base: Optional[str] = None,
                 path_outputs_base: str = "/tmp/stroke-prediction",
                 seed: int = 4, distances_on_training: bool = False,
                 log_throughput: bool = False,
                 profile_dir: Optional[str] = None, device=None, mesh=None,
                 device_cache: Optional[bool] = None):
        if dataloader_training.batch_size <= 1:
            raise ValueError("For normalization layers batch_size > 1 is "
                             "required.")
        self.device = resolve_device(device)
        self._dataloader_training = dataloader_training
        self._dataloader_validation = dataloader_validation
        self._model = model
        self._optimizer = optimizer
        # the ramp's end point: the optimizer's betas as it was built
        self._base_betas = tuple(optimizer.defaults["betas"])
        self._lr_schedule = lr_schedule
        self._n_epochs = n_epochs
        self._path_outputs_base = path_outputs_base
        self._path_previous_base = path_previous_base
        # HD/ASSD on validation batches always, on training batches too
        # when set (``--distances``)
        self._distances_on_training = distances_on_training
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._dev_data: Dict[Any, tuple] = {}
        self._mesh = mesh
        self._no_plots_said = False
        self._metric_dtos: Dict[str, List[dict]] = {"training": [],
                                                    "validate": []}
        # steps run, by kind, and the training passes' (seconds, steps):
        # read by callers that count kernel launches or time steps
        self.step_counts = {"train": 0, "eval": 0, "visual": 0}
        self.train_pass_seconds: List[tuple] = []
        # pass-level timing: the first training pass is warm-up
        self._timer = StepTimer(warmup_steps=1,
                                n_chips=mesh.world if mesh else 1)
        self._log_throughput = log_throughput
        self._profile_dir = profile_dir
        if device_cache is None:
            device_cache = os.environ.get("STROKE_TPU_DEVICE_CACHE",
                                          "1") != "0"
        self._device_cache = device_cache
        # the device plan: per loader role, and a step runner per (phase,
        # group); the epoch's loss factor, which every step reads
        self._plans: Dict[str, dict] = {}
        self._planned: Dict[Tuple[bool, int], Callable] = {}
        self._graph_pool = None
        self._factor = torch.zeros((), dtype=torch.float64,
                                   device=self.device)
        # the planned passes' graph replays on the card
        self.graph_replays = 0

        if path_previous_base is not None:
            self.load_model()
            self.load_training()
            print("Continue training", path_previous_base, "...")
        if len(self._metric_dtos["training"]) != len(
                self._metric_dtos["validate"]):
            raise ValueError("Incomplete training data!")

    # ---------------------------------------------------------------- paths

    def path(self, mode: str, type_: str, suffix: str = "") -> Optional[str]:
        base = {"load": self._path_previous_base,
                "save": self._path_outputs_base}.get(mode)
        if base is None:
            return None
        ext = {"model": self.EXT_MODEL, "optim": self.EXT_OPTIM,
               "train": self.EXT_TRAIN, "plots": self.EXT_IMAGE,
               "image": self.EXT_IMAGE}.get(type_)
        if ext is None:
            return None
        return base + self.FNB_MARKS + suffix + ext

    def _with_distances(self, training: bool) -> bool:
        return not training or self._distances_on_training

    # ------------------------------------------------------- subclass hooks

    def train_step(self, batch: Dict[str, torch.Tensor],
                   factor: float = 0.0) -> dict:
        """One optimizer step on a device batch at the epoch's
        :meth:`loss_factor` (a number, or in the learner's loops a 0-d
        float64 device tensor); returns 0-d metric tensors (still on the
        device).  Reads nothing on the host: a CUDA graph captures it."""
        raise NotImplementedError

    def eval_step(self, batch: Dict[str, torch.Tensor],
                  factor: float = 0.0) -> dict:
        raise NotImplementedError

    def model_config(self) -> Dict[str, Any]:
        return {}

    def state_tree(self) -> Dict[str, Any]:
        """The model's flax variable tree (numpy leaves) for ``.model``."""
        raise NotImplementedError

    def load_state_tree(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def print_epoch(self, epoch, phase, m: dict):
        pass

    def plot_epoch(self, plot, epochs):
        pass

    def visualize_epoch(self, epoch):
        pass

    # ------------------------------------------------------------ schedules

    def adapt_lr(self, epoch):
        """MultiStepLR step at epoch start."""
        if self._lr_schedule is not None:
            set_learning_rate(self._optimizer, self._lr_schedule(epoch))

    def adapt_betas(self, epoch):
        """The beta1 warm ramp over the first ``N_EPOCHS_ADAPT_BETA1``
        epochs; none unless that is set."""
        if self.N_EPOCHS_ADAPT_BETA1 is None:
            return
        b1 = beta1_ramp(self._base_betas[0], epoch, self.N_EPOCHS_ADAPT_BETA1)
        set_beta1(self._optimizer, b1)
        if epoch <= self.N_EPOCHS_ADAPT_BETA1 and is_lead():
            print("Momentum betas have been set to:",
                  (b1, self._base_betas[1]), end=" ")

    def loss_factor(self, epoch: int) -> float:
        """Curriculum weight of epoch-dependent loss terms (subclasses)."""
        return 0.0

    # --------------------------------------------------------- resume hooks

    def get_start_epoch(self) -> int:
        return len(self._metric_dtos["training"])

    def get_start_min_loss(self) -> float:
        losses = [m["loss"] for m in self._metric_dtos["validate"]
                  if m.get("loss") is not None]
        return min(losses) if losses else np.inf

    # ------------------------------------------------------------ persist

    def save_model(self, suffix: str = ""):
        if not is_lead():
            return
        ckpt.save_checkpoint(self.path("save", "model", suffix),
                             self.state_tree(), self.model_config())

    def load_model(self):
        state, _ = ckpt.load_checkpoint(self.path("load", "model"))
        self.load_state_tree(state)

    def save_training(self):
        if not is_lead():
            return
        ckpt.save_checkpoint(
            self.path("save", "optim"),
            {"opt_state": adam_state_to_jax(self._optimizer, self._model)})
        ckpt.save_curves(self.path("save", "train"), self._metric_dtos)

    def load_training(self):
        path_t = self.path("load", "train")
        path_o = self.path("load", "optim")
        print("Loading:", path_t, path_o)
        opt, _ = ckpt.load_checkpoint(path_o)
        self._optimizer.load_state_dict(adam_state_from_jax(
            opt["opt_state"], self._model, self._optimizer))
        self._metric_dtos = ckpt.load_curves(path_t)

    # ------------------------------------------------------------ the loop

    def device_data(self, loader):
        """The loader's cases stacked on the device once: (arrays,
        dataset index -> row)."""
        key = (id(loader.dataset), tuple(loader.indices))
        entry = self._dev_data.get(key)
        if entry is None:
            stack = loader.dataset.stack(loader.indices)
            data = {k: (None if stack.get(k) is None else
                        torch.from_numpy(stack[k]).to(self.device))
                    for k in (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL)}
            rowmap = {idx: row for row, idx in enumerate(loader.indices)}
            entry = (data, rowmap)
            self._dev_data[key] = entry
        return entry

    def _batches(self, loader):
        """(sharding, device batch, global volumes) for each chunk of one
        epoch: from the device cache by the row rule, or, for a
        ``process_shard`` loader, this process's share staged from the
        host."""
        if loader.process_shard:
            sharding = batch_sharding(self._mesh)
            put = DevicePut(self.device, (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL))
            for staged in prefetch_to_device(loader, put):
                batch = staged.wait()
                yield (sharding, batch,
                       sharding.global_size(len(batch[KEY_IMAGES])))
            return
        data, rowmap = self.device_data(loader)
        for chunk in loader.epoch_chunks():
            sharding = row_sharding(self._mesh, len(chunk))
            rows = torch.tensor([rowmap[i] for i in sharding.take(chunk)],
                                dtype=torch.int64, device=self.device)
            batch = {k: (None if v is None else v.index_select(0, rows))
                     for k, v in data.items()}
            yield sharding, batch, len(chunk)

    def _plans_loader(self, loader) -> bool:
        """Whether passes over ``loader`` run from the device plan: the
        device cache on, one process (no ``process_shard`` loader, no mesh
        of more than one rank)."""
        return (self._device_cache and not loader.process_shard
                and (self._mesh is None or self._mesh.world == 1))

    def _make_plan(self, loader, epoch0: int) -> dict:
        """Every remaining epoch's chunks of ``loader`` as device row
        tensors (the JAX learner's ``_make_plan``): per block of
        ``PLAN_BLOCK`` epochs and per group of consecutive equal-sized
        chunks an int64 ``(epochs, chunks, size + 1)`` tensor, each row
        vector the chunk's rows then its step's slot in the pass."""
        _, rowmap = self.device_data(loader)
        n_epochs = self._n_epochs - epoch0
        per_epoch = [loader.epoch_chunks() for _ in range(n_epochs)]
        sizes = [len(c) for c in per_epoch[0]] if per_epoch else []
        if any([len(c) for c in chunks] != sizes for chunks in per_epoch):
            raise ValueError("the epochs' chunk sizes differ")
        bounds, i = [], 0
        while i < len(sizes):
            j = i
            while j < len(sizes) and sizes[j] == sizes[i]:
                j += 1
            bounds.append((i, j, sizes[i]))
            i = j
        k = self.PLAN_BLOCK
        blocks = [[torch.tensor([[[rowmap[x] for x in c] + [i + n]
                                  for n, c in enumerate(chunks[i:j])]
                                 for chunks in per_epoch[b0:b0 + k]],
                                dtype=torch.int64, device=self.device)
                   for i, j, _ in bounds]
                  for b0 in range(0, n_epochs, k)]
        return {"epoch0": epoch0, "n_epochs": n_epochs, "bounds": bounds,
                "blocks": blocks, "n_steps": len(sizes),
                "n_vol": sum(sizes), "keys": None, "out": None}

    def _plan_of(self, loader, epoch: int) -> dict:
        role = "train" if loader is self._dataloader_training else "valid"
        plan = self._plans.get(role)
        if plan is None:
            plan = self._plans[role] = self._make_plan(loader, epoch)
        return plan

    def _runner(self, loader, plan: dict, training: bool,
                group: int) -> Callable:
        """The step runner of (phase, group): ``run(block, k)`` runs the
        step of the ``k``-th row vector of ``block`` (one of the group's
        plan tensors, its vectors taken epoch by epoch).

        The runner holds a static buffer: a cursor, then room for a whole
        block's row vectors.  A step reads its vector at the cursor (rows,
        then slot), gathers the batch on the device, runs the learner's
        step at the pass's loss factor, writes its metrics into the slot's
        row of the pass's buffer (made at the first step, which names the
        keys) and moves the cursor on.  So on the card a step is one
        replay: the host copies a block into the buffer once (every
        ``PLAN_BLOCK`` epochs) and sets the cursor only where ``k`` is not
        where it stands.  The first step runs eagerly (a real step: it
        builds the kernels and lets cuDNN choose), and a CUDA graph of the
        step is captured after it; on the CPU, or with ``eager=True``,
        every step runs eagerly."""
        key = (training, group)
        if key in self._planned:
            return self._planned[key]
        i, j, size = plan["bounds"][group]
        room = self.PLAN_BLOCK * (j - i)
        static = torch.zeros(1 + room * (size + 1), dtype=torch.int64,
                             device=self.device)
        cursor, vectors = static[:1], static[1:].view(room, size + 1)
        data, _ = self.device_data(loader)
        step = self.train_step if training else self.eval_step
        kind = "train" if training else "eval"
        at = {"block": None, "k": 0, "n": 0, "graph": None}

        def body() -> None:
            idx = vectors.index_select(0, cursor)[0]
            rows = idx[:-1]
            metrics = step({k: (None if v is None else v.index_select(0, rows))
                            for k, v in data.items()}, self._factor)
            if plan["out"] is None:
                plan["keys"] = sorted(metrics)
                plan["out"] = torch.zeros(
                    (plan["n_steps"], len(plan["keys"])),
                    dtype=torch.float32, device=self.device)
            plan["out"].index_copy_(0, idx[-1:], torch.stack(
                [metrics[k].float() for k in plan["keys"]])[None])
            cursor.add_(1)

        def run(block: torch.Tensor, k: int, eager: bool = False) -> None:
            if at["block"] is not block:
                flat = block.view(-1, size + 1)
                vectors[:len(flat)].copy_(flat)
                at["block"], at["k"], at["n"] = block, None, len(flat)
            if not 0 <= k < at["n"]:
                # a read past the block would fault on the card
                raise IndexError(f"step {k} of a block of {at['n']}")
            if at["k"] != k:
                cursor.fill_(k)
            if eager or self.device.type != "cuda":
                body()
            elif at["graph"] is None:
                body()
                at["graph"] = self._capture(body)
            else:
                at["graph"].replay()
                self.graph_replays += 1
                self.step_counts[kind] += 1
            at["k"] = k + 1

        self._planned[key] = run
        return run

    def _capture(self, body: Callable):
        """``body()`` captured into a CUDA graph in the learner's one
        memory pool, with the learner's generator registered; the step
        counts are left as they were (a capture runs nothing)."""
        if self._profile_dir is not None:
            prepare_graph_trace()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        self._register_generators(graph)
        counts = dict(self.step_counts)
        with torch.cuda.graph(graph, pool=self._graph_pool):
            body()
        self.step_counts.update(counts)
        return graph

    def _register_generators(self, graph) -> None:
        """Each replay of ``graph`` draws from the learner's generator's
        state then and moves it on, as the eager step does."""
        graph.register_generator_state(self._generator)

    def _planned_pass(self, loader, epoch: int, training: bool):
        """One epoch phase from the device plan -> (per-step metric
        values, keys, global volumes)."""
        plan = self._plan_of(loader, epoch)
        e = epoch - plan["epoch0"]
        if not 0 <= e < plan["n_epochs"]:
            raise ValueError(f"epoch {epoch} is outside the plan")
        block, slot = divmod(e, self.PLAN_BLOCK)
        phase = "train_step" if training else "eval_step"
        t0 = time.perf_counter()
        for group, (i, j, _) in enumerate(plan["bounds"]):
            run = self._runner(loader, plan, training, group)
            for c in range(j - i):
                with annotate(phase):
                    run(plan["blocks"][block][group], slot * (j - i) + c)
        t1 = time.perf_counter()
        host = plan["out"].cpu().tolist() if plan["out"] is not None else []
        if os.environ.get("STROKE_TPU_TIME_EPOCH") == "1":
            print(f"[epoch-probe] {'train' if training else 'eval'} "
                  f"dispatch {1e3 * (t1 - t0):.1f}ms fetch "
                  f"{1e3 * (time.perf_counter() - t1):.1f}ms", flush=True)
        return host, plan["keys"] or [], plan["n_vol"]

    def _eager_pass(self, loader, epoch: int, training: bool):
        """One epoch phase step by step from Python -> (per-step metric
        values, keys, global volumes)."""
        phase = "train_step" if training else "eval_step"
        step = self.train_step if training else self.eval_step
        results, n_volumes = [], 0
        for sharding, batch, n in self._batches(loader):
            with annotate(phase), sharding.active():
                results.append(step(batch, self._factor))
            n_volumes += n
        # ONE device -> host fetch per epoch phase
        keys = sorted(results[0]) if results else []
        host = (torch.stack([torch.stack([m[k].float() for k in keys])
                             for m in results]).cpu().tolist()
                if results else [])
        return host, keys, n_volumes

    def _run_epoch(self, loader, epoch: int, training: bool) -> dict:
        t0 = time.perf_counter()
        if training:
            self._timer.start()
        # the epoch's loss factor as device state, in both loops alike: a
        # step computes the same bits from it whichever loop runs it
        self._factor.fill_(self.loss_factor(epoch))
        run_pass = (self._planned_pass if self._plans_loader(loader)
                    else self._eager_pass)
        host, keys, n_volumes = run_pass(loader, epoch, training)
        if training:
            self.train_pass_seconds.append((time.perf_counter() - t0,
                                            len(host)))
            self._timer.stop(n_volumes)
            if self._log_throughput:
                print(f"[throughput] {self._timer.summary()}", end=" ")
        # accumulate like MeasuresDto.add (inf propagates through +=),
        # divide like MeasuresDto.div (inf kept as-is)
        accum: Dict[str, float] = {}
        for vals in host:
            for k, v in zip(keys, vals):
                accum[k] = accum.get(k, 0.0) + float(v)
        count = max(len(host), 1)
        return {k: (v / count if np.isfinite(v) else v)
                for k, v in accum.items()}

    def run_training(self):
        min_loss = self.get_start_min_loss()
        epoch = self.get_start_epoch()
        for epoch in range(self.get_start_epoch(), self._n_epochs):
            self.adapt_lr(epoch)
            self.adapt_betas(epoch)

            # trace the second training pass (the first holds the kernel
            # build and warm-up), or the only one
            trace_epoch = min(self.get_start_epoch() + 1, self._n_epochs - 1)
            with (trace(self._profile_dir) if self._profile_dir is not None
                  and epoch == trace_epoch else contextlib.nullcontext()):
                m_train = self._run_epoch(self._dataloader_training, epoch,
                                          training=True)
            lead = is_lead()
            if lead:
                self.print_epoch(epoch, "training", m_train)
            self._metric_dtos["training"].append(m_train)

            if self._dataloader_validation is None:
                m_valid = {"loss": 0.0}
            else:
                m_valid = self._run_epoch(self._dataloader_validation,
                                          epoch, training=False)
            if lead:
                self.print_epoch(epoch, "validate", m_valid)
            self._metric_dtos["validate"].append(m_valid)

            if m_valid.get("loss") is not None and m_valid["loss"] < min_loss:
                min_loss = m_valid["loss"]
                self.save_model()
                self.save_training()
                if lead:
                    print("(New optimum: Training saved)", end=" ")
                    self.visualize_epoch(epoch)

            if epoch % 50 == 0 and lead:
                self.visualize_epoch(epoch)

            if epoch > 0 and lead:
                self._plot_curves(epoch)

        self.save_model("_final")
        if is_lead():
            self.visualize_epoch(epoch)

    # ------------------------------------------------------------- plots

    def pyplot(self):
        """matplotlib.pyplot (Agg), or None after saying once that no PNGs
        are written."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            if not self._no_plots_said:
                print("matplotlib is not installed: no PNGs are written")
                self._no_plots_said = True
            return None
        return plt

    def _plot_curves(self, epoch):
        plt = self.pyplot()
        if plt is None:
            return
        fig, plot = plt.subplots()
        try:
            self.plot_epoch(plot, range(1, epoch + 2))
            fig.savefig(self._path_outputs_base + self.FN_VIS_BASE
                        + "plots.png", bbox_inches="tight", dpi=300)
        finally:
            plt.close(fig)
