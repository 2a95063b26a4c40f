"""DistributedStrategy — the port of paddle_tpu/distributed/strategy.py
(reference `fleet/base/distributed_strategy.py` +
`framework/distributed_strategy.proto:26-228`): the same toggles with
the same defaults. The JAX module imports no JAX; the port keeps its own
copy. In the port:

  amp             -> the bf16 policy of `paddle_tpu_torch.amp`
  sharding        -> ZeRO-1/2 state sharding over dp (ShardedTrainStep;
                     `sharding_configs["stage"]`)
  tensor_parallel -> the mp mesh axis and the parameters' `mesh_axes`
  hybrid_configs  -> the mesh degrees `fleet.init` builds
"""
import copy


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True,
                            "custom_white_list": [], "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.sharding = False
        self.sharding_configs = {"sharding_degree": 1, "stage": 1,
                                 "segment_broadcast_MB": 32.0,
                                 "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        # fp16_allreduce: kept for API parity, refuses True (the
        # property below) rather than being accepted and ignored
        self._fp16_allreduce = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1,
                               "ep_degree": 1}
        self.a_sync = False
        self.a_sync_configs = {}
        self.elastic = False
        self.auto = False

    @property
    def fp16_allreduce(self):
        return self._fp16_allreduce

    @fp16_allreduce.setter
    def fp16_allreduce(self, value):
        if value:
            raise ValueError(
                "fp16_allreduce is not a separate switch: the gradient "
                "exchange's precision follows the gradient dtype. Set "
                "strategy.amp = True (bf16 policy) for bf16 activations; "
                "the reference's fp16_allreduce_optimizer.py has no "
                "counterpart")
        self._fp16_allreduce = False

    def __repr__(self):
        fields = {k.lstrip("_"): v for k, v in self.__dict__.items()
                  if not k.endswith("_configs")}
        return f"DistributedStrategy({fields})"

    def copy(self):
        return copy.deepcopy(self)
