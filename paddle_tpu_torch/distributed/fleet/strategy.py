"""DistributedStrategy — the port's copy of
``paddle_tpu/distributed/fleet/strategy.py``.

Reference parity: ``fleet/base/distributed_strategy.py:104`` wrapping
``framework/distributed_strategy.proto`` (amp / recompute / sharding /
pipeline / hybrid / localsgd / gradient_merge / lamb / lars knobs).  A
plain attribute bag with the same field names and defaults, consumed by
``TrainStep`` and ``fleet.build_train_step``; ``save_to_prototxt`` /
``load_from_prototxt`` write and read it as JSON, as the JAX package's
do, so one file configures either package.
"""
from __future__ import annotations

import json


class DistributedStrategy:
    def __init__(self):
        # precision (proto: amp, amp_configs)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_bf16": True,
        }
        # memory (proto: recompute, recompute_configs)
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        # ZeRO (proto: sharding, sharding_configs:32-35)
        self.sharding = False
        self.sharding_configs = {
            "sharding_degree": 1,
            "stage": 2,
            "hybrid_dp": False,
            "fuse_broadcast_MB": 32.0,
        }
        # pipeline (proto: pipeline, pipeline_configs:120)
        self.pipeline = False
        self.pipeline_configs = {
            "micro_batch_size": 1,
            "accumulate_steps": 1,
            "schedule_mode": "F-then-B",
        }
        # hybrid mesh degrees (2.x hybrid_configs)
        self.hybrid_configs = {
            "dp_degree": 0,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        # comm reduction
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1,
                                          "begin_step": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.fp16_allreduce = False
        self.dgc = False
        # large-batch opts
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        # misc proto fields kept for API parity
        self.a_sync = False
        self.a_sync_configs = {}
        self.elastic = False
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1

    # proto-style save/load (reference: save_to_prototxt/load_from_prototxt)
    def save_to_prototxt(self, path):
        with open(path, "w") as f:
            json.dump({k: v for k, v in self.__dict__.items()}, f, indent=2)

    def load_from_prototxt(self, path):
        with open(path) as f:
            data = json.load(f)
        self.__dict__.update(data)

    def __repr__(self):
        lines = ["DistributedStrategy:"]
        for k, v in sorted(self.__dict__.items()):
            lines.append(f"  {k} = {v}")
        return "\n".join(lines)
