"""hapi callbacks (reference: python/paddle/hapi/callbacks.py) —
counterpart of ``paddle_tpu/hapi/callbacks.py``, pure Python over the
port's ``Model`` and optimizers."""
from __future__ import annotations

import os
import time


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            total = self.steps if self.steps else "?"
            print(f"Epoch {self.epoch}: step {step}/{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done ({dt:.1f}s) - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Eval - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        from ..optimizer.lr import LRScheduler as Sched
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, save_freq=1, save_dir=None, metrics=None):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    params = {"epochs": epochs, "steps": steps, "verbose": verbose,
              "metrics": metrics or []}
    for c in cbks:
        c.set_params(params)
        c.set_model(model)
    return CallbackList(cbks)


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return call


class ReduceLROnPlateau(Callback):
    """reference: hapi/callbacks.py ReduceLROnPlateau — shrink LR when the
    monitored metric stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        lower_better = mode == "min" or (mode == "auto"
                                         and "acc" not in monitor)
        self._better = ((lambda a, b: a < b - min_delta) if lower_better
                        else (lambda a, b: a > b + min_delta))
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur)
        if self._best is None or self._better(cur, self._best):
            self._best = cur
            self._wait = 0
            return
        if self._cooldown_left > 0:
            # patience accounting pauses while the reduced LR takes effect
            self._cooldown_left -= 1
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = self.model._optimizer
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f"Epoch {epoch}: ReduceLROnPlateau reducing "
                          f"learning rate to {new}.")
            self._cooldown_left = self.cooldown
            self._wait = 0


class VisualDL(Callback):
    """reference: hapi/callbacks.py VisualDLCallback.  The visualdl
    package is not vendored; scalars stream to JSON-lines under log_dir
    (one record per step/epoch), which its UI and any reader can ingest."""

    def __init__(self, log_dir="./log"):
        self.log_dir = log_dir
        self._fh = None
        self._step = 0

    def on_train_begin(self, logs=None):
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def _write(self, tag, logs):
        import json as _json
        if not self._fh or not logs:
            return
        rec = {"step": self._step, "tag": tag}
        rec.update({k: float(v) for k, v in logs.items()
                    if isinstance(v, (int, float))})
        self._fh.write(_json.dumps(rec) + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % 10 == 0:
            self._write("train", logs)

    def on_epoch_end(self, epoch, logs=None):
        self._write("epoch", logs)

    def on_train_end(self, logs=None):
        if self._fh:
            self._fh.close()
            self._fh = None
