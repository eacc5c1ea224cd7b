"""The port's copy of ``tests/fault_recovery_worker.py``: deterministic
training under ``paddle_tpu_torch.incubate.checkpoint.TrainEpochRange``;
optionally dies HARD (``os._exit``, the SIGKILL/preemption analogue)
right after a given epoch's steps, before its snapshot.  Writes the final
weights to OUT_PATH when it survives all epochs.  ``DEVICE`` (default
``cpu``) is the place it trains on."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange  # noqa

kill_after = int(os.environ.get("KILL_AFTER_EPOCH", "-1"))
out_path = os.environ["OUT_PATH"]

paddle.set_device(os.environ.get("DEVICE", "cpu"))
paddle.seed(7)
net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 2))
opt = optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                         parameters=net.parameters())
r = TrainEpochRange(6, name="faultjob").attach(net, opt)

rs = np.random.RandomState(0)
x = paddle.to_tensor(rs.rand(8, 6).astype("float32"))
y = paddle.to_tensor(rs.randint(0, 2, (8,)).astype("int64"))
lossf = nn.CrossEntropyLoss()

for epoch in r.get():
    # 3 deterministic steps per epoch
    for _ in range(3):
        loss = lossf(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    print(f"EPOCH {epoch} loss {float(loss.numpy()):.6f}", flush=True)
    if epoch == kill_after:
        # hard death BEFORE this epoch's snapshot (get() saves after
        # the yield returns): the resume must REDO this epoch
        os._exit(137)

state = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
np.savez(out_path, **state)
print("DONE", flush=True)
