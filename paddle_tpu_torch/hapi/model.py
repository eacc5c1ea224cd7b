"""paddle.Model — the high-level train loop; counterpart of
``paddle_tpu/hapi/model.py`` (reference: ``python/paddle/hapi/model.py:810``,
Model.prepare/fit/evaluate/predict/save/load).

``prepare`` builds a ``parallel.TrainStep`` exactly as a user would
(``TrainStep(network, optimizer, loss_fn=loss, strategy=strategy,
amp_level=..., metrics=...)``, on the network's device), and ``fit``
feeds it: the loader's host batches go through
``io.DeviceLoader(loader, buffer_size=2)``, which pins and uploads them
on a stream of its own while the previous step computes.  The metrics'
per-step inputs come out of the step (``last_metric_outs``, computed on
the card) in one device-to-host copy and are accumulated on the host.

``network`` is a port ``nn.Layer`` or any ``torch.nn.Module`` (the
port's BERT and GPT are the latter).  Evaluation and prediction run the
network eagerly in eval mode under ``no_grad`` (the JAX package compiles
one program a shape).  ``save`` writes ``path.pdparams`` (the network's
``state_dict``, handles or torch tensors as it holds them, in the JAX
package's file format) and ``path.pdopt`` (the optimizer's state in the
JAX package's format, keyed by the network's parameter names);
nothing is transposed.  ``summary`` records each sublayer's output shape
with forward hooks over a zero input; ``flops`` counts the matrix
products and convolutions of one eval forward with
``torch.utils.flop_counter.FlopCounterMode`` (XLA's cost analysis,
which the JAX package reads, also counts elementwise work).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.tensor import Tensor
from ..io import DataLoader, DeviceLoader
from ..nn.layer.base import torch_named_parameters
from ..parallel.train_step import TrainStep
from . import callbacks as cbks_mod


def _metric_to_host(outs):
    """The step's metric outputs (lists of torch tensors on the device)
    as numpy, through one device-to-host copy of all of them."""
    flat = [x for mo in outs for x in mo]
    ts = [x for x in flat if isinstance(x, torch.Tensor)]
    if not ts:
        return [[np.asarray(x) for x in mo] for mo in outs]
    dev = ts[0].device
    joined = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                        for t in ts]).cpu().numpy()
    host, off = {}, 0
    for t in ts:
        n = t.numel()
        dt = np.float32 if t.dtype == torch.bfloat16 else \
            torch.empty((), dtype=t.dtype).numpy().dtype
        host[id(t)] = joined[off:off + n].reshape(tuple(t.shape)).astype(dt)
        off += n
    return [[host[id(x)] if isinstance(x, torch.Tensor) else np.asarray(x)
             for x in mo] for mo in outs]


def _named_values(metric, vals):
    """``{name: value}`` of a metric's ``accumulate()``."""
    names = metric.name()
    if not isinstance(names, (list, tuple)):
        names, vals = [names], [vals]
    if not isinstance(vals, (list, tuple)):
        vals = [vals]
    return dict(zip(names, vals))


def _host_batches(loader):
    return loader.host_batches() if hasattr(loader, "host_batches") \
        else iter(loader)


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self.stop_training = False
        self._mode = "train"
        self._strategy = None
        self._amp_level = None
        # per fit step: host ms blocked in next(feed), and ms a step
        # (the wait, the step, the metrics and the callbacks)
        self.fit_wait_ms = []
        self.fit_step_ms = []

    @property
    def mode(self):
        """reference: hapi/model.py:256 — 'train' / 'eval' / 'test'."""
        return self._mode

    @mode.setter
    def mode(self, value):
        self._mode = value
        if value == "train":
            self.network.train()
        else:
            self.network.eval()

    def _device(self):
        for _, p in torch_named_parameters(self.network):
            return p.device
        from ..core import device as core_device
        return core_device.torch_device()

    def _step(self):
        return TrainStep(self.network, self._optimizer, loss_fn=self._loss,
                         strategy=self._strategy, amp_level=self._amp_level,
                         metrics=self._metrics, device=self._device())

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, strategy=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        amp_level = None
        if amp_configs:
            amp_level = amp_configs.get("level", "O1") if isinstance(
                amp_configs, dict) else "O1"
        self._strategy = strategy
        self._amp_level = amp_level
        if optimizer is not None:
            self._train_step = self._step()
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return [batch[0]], list(batch[1:])
            return [batch[0]], []
        return [batch], []

    def _update_metrics(self):
        """Each metric updated with the last step's outputs; returns
        ``[(metric, accumulate())]``."""
        out = []
        for m, mo in zip(self._metrics,
                         _metric_to_host(self._train_step.last_metric_outs)):
            m.update(*mo)
            out.append((m, m.accumulate()))
        return out

    def train_batch(self, inputs, labels=None, update=True):
        """One train step on a batch (reference: model.py:896); the
        metrics computed inside the step are accumulated here."""
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is not None else []
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        loss = self._train_step.step(list(inputs), list(labels))
        return [float(loss)] + [v for _, v in self._update_metrics()]

    def _to_device(self, xs):
        dev = self._device()
        out = []
        for x in xs:
            if isinstance(x, Tensor):
                x = x._data
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            out.append(x.to(dev))
        return out

    def _forward_eval(self, inputs):
        """The eval-mode forward, eager, under ``no_grad``."""
        with torch.no_grad():
            return self.network(*self._to_device(inputs))

    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is not None else []
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        self._sync_weights()
        prev = self.mode
        self.mode = "eval"
        try:
            out = self._forward_eval(inputs)
            labs = self._to_device(labels)
            losses = []
            with torch.no_grad():
                if self._loss is not None and labs:
                    losses.append(float(self._loss(out, *labs)))
                for m in self._metrics:
                    mo = m.compute(out, *labs)
                    mo = list(mo) if isinstance(mo, (list, tuple)) \
                        else [mo]
                    m.update(*_metric_to_host([mo])[0])
        finally:
            self.mode = prev
        return losses, _wrap(out)

    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._sync_weights()
        prev = self.mode
        self.mode = "test"
        try:
            out = self._forward_eval(inputs)
        finally:
            self.mode = prev
        return _wrap(out)

    def _sync_weights(self):
        if self._train_step is not None:
            self._train_step.sync_to_layer()

    # ------------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        assert self._train_step is not None, "call prepare() first"
        if isinstance(train_data, DataLoader):
            loader = train_data
        else:
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            verbose=verbose, save_freq=save_freq, save_dir=save_dir,
            metrics=[m.name() for m in self._metrics])
        # the buffered reader: host batches pinned and uploaded on a
        # stream of their own while the previous step computes
        feed = loader
        if not self._train_step.is_pipeline:
            dev = self._train_step.device
            feed = DeviceLoader(loader, buffer_size=2,
                                sharding_fn=lambda shape: dev)
        self.stop_training = False
        self.fit_wait_ms, self.fit_step_ms = [], []
        cbks.on_train_begin()
        it = 0
        for epoch in range(epochs):
            if hasattr(loader, "batch_sampler") and hasattr(
                    loader.batch_sampler, "set_epoch"):
                loader.batch_sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            last_logs = {}
            batches = iter(feed)
            step = 0
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                loss = self._train_step.step(ins, labs)
                last_logs = {"loss": float(loss),
                             "lr": self._optimizer.get_lr()}
                for m, vals in self._update_metrics():
                    last_logs.update(_named_values(m, vals))
                cbks.on_train_batch_end(step, last_logs)
                self.fit_wait_ms.append((t1 - t0) * 1e3)
                self.fit_step_ms.append((time.perf_counter() - t0) * 1e3)
                step += 1
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, last_logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data,
                                          batch_size=batch_size,
                                          verbose=0,
                                          num_workers=num_workers)
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        cbks.on_train_end()
        self._sync_weights()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        if isinstance(eval_data, DataLoader):
            loader = eval_data
        else:
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in _host_batches(loader):
            ins, labs = self._split_batch(batch)
            batch_losses, _ = self.eval_batch(ins, labs)
            losses.extend(batch_losses)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs.update(_named_values(m, m.accumulate()))
        if verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        if isinstance(test_data, DataLoader):
            loader = test_data
        else:
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        outputs = []
        for batch in _host_batches(loader):
            ins, _ = self._split_batch(batch)
            out = self.predict_batch(ins)
            outputs.append(out.numpy() if isinstance(out, Tensor) else out)
        if stack_outputs:
            return [np.concatenate(outputs)]
        return [outputs]

    # ------------------------------------------------------------------
    def _optimizer_state(self):
        """The optimizer's state in the JAX package's format, keyed
        ``{parameter name in the network}__{key}``, so that a fresh
        network's optimizer finds it."""
        opt = self._optimizer
        st = opt.paddle_state_dict()
        out = {k: st[k] for k in ("__step__", "LR_Scheduler") if k in st}
        for name, p in torch_named_parameters(self.network):
            for key, v in opt.state.get(p, {}).items():
                out[f"{name}__{key}"] = v
        return out

    def _set_optimizer_state(self, state):
        opt = self._optimizer
        own = {id(p): n for n, p in opt._state_names()}
        staged = {k: state[k] for k in ("__step__", "LR_Scheduler")
                  if k in state}
        for name, p in torch_named_parameters(self.network):
            prefix = f"{name}__"
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(prefix):
                    staged[f"{own[id(p)]}__{k[len(prefix):]}"] = v
        opt.set_state_dict(staged)

    def save(self, path, training=True):
        from ..framework.io import save as fsave
        self._sync_weights()
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer_state(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import os
        from ..framework.io import load as fload
        from ..nn.layer.base import Layer
        state = fload(path + ".pdparams", return_numpy=True)
        if isinstance(self.network, Layer):
            self.network.set_state_dict(state)
        else:
            own = self.network.state_dict()
            self.network.load_state_dict(
                {k: torch.as_tensor(v).to(own[k].dtype) if k in own
                 else torch.as_tensor(v) for k, v in state.items()},
                strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._set_optimizer_state(fload(path + ".pdopt",
                                            return_numpy=True))
        if self._optimizer is not None:
            self._train_step = self._step()

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def _zero_inputs(self, input_size, dtype):
        shapes = input_size if isinstance(input_size[0], (list, tuple)) \
            else [input_size]
        dt = getattr(torch, str(dtype or "float32"))
        return [torch.zeros(tuple(s), dtype=dt, device=self._device())
                for s in shapes]

    def summary(self, input_size=None, dtype=None):
        """Layer-by-layer summary (reference: hapi summary.py prints
        Layer (type), Output Shape, Param #).  With ``input_size`` an
        eval-mode forward over zeros on the network's device, under
        ``no_grad``, records every sublayer's output shape by forward
        hooks; without it, the parameter table."""
        net = self.network
        if input_size is not None:
            records, handles = [], []

            def mk_hook(name):
                def hook(lyr, inputs, outputs):
                    out = outputs[0] if isinstance(outputs, (tuple, list)) \
                        else outputs
                    shape = list(getattr(out, "shape", []) or [])
                    n_params = sum(p.numel() for p in
                                   torch.nn.Module.parameters(
                                       lyr, recurse=False))
                    records.append((name, type(lyr).__name__, shape,
                                    n_params))
                return hook

            for name, sub in net.named_modules():
                if name:
                    handles.append(sub.register_forward_hook(mk_hook(name)))
            prev = self.mode
            self.mode = "eval"
            try:
                with torch.no_grad():
                    net(*self._zero_inputs(input_size, dtype))
            finally:
                self.mode = prev
                for h in handles:
                    h.remove()
            lines = ["-" * 76,
                     f"{'Layer (type)':<36}{'Output Shape':<24}"
                     f"{'Param #':>12}",
                     "=" * 76]
            for name, tname, shape, n_params in records:
                lines.append(f"{name + ' (' + tname + ')':<36}"
                             f"{str(shape):<24}{n_params:>12,}")
        else:
            lines = ["-" * 76,
                     f"{'Parameter':<44}{'Shape':<20}{'Count':>12}",
                     "=" * 76]
            for name, p in torch_named_parameters(net):
                lines.append(f"{name:<44}{str(list(p.shape)):<20}"
                             f"{p.numel():>12,}")
        params = [p for _, p in torch_named_parameters(net)]
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        lines += ["=" * 76,
                  f"Total params: {total:,}",
                  f"Trainable params: {trainable:,}",
                  f"Non-trainable params: {total - trainable:,}",
                  "-" * 76]
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}

    def flops(self, inputs=None, input_size=None, dtype="float32",
              print_detail=False):
        """FLOPs of one eval-mode forward: the matrix products' and
        convolutions' (2 a multiply-add), counted by
        ``torch.utils.flop_counter.FlopCounterMode``."""
        from torch.utils.flop_counter import FlopCounterMode
        if inputs is None:
            if input_size is None:
                raise ValueError("flops: pass example inputs or "
                                 "input_size")
            xs = self._zero_inputs(input_size, dtype)
        else:
            xs = self._to_device(inputs if isinstance(inputs, (list, tuple))
                                 else [inputs])
        prev = self.mode
        self.mode = "eval"
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                self.network(*xs)
        finally:
            self.mode = prev
        total = int(fc.get_total_flops())
        if print_detail:
            print(f"FLOPs (matrix products and convolutions, eval "
                  f"forward): {total:,}")
        return total
