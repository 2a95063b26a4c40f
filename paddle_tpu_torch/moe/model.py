"""GPTMoE: the GPT family with mixture-of-experts FFN blocks.

Counterpart of paddle_tpu/moe/model.py. The embedding, attention and
LayerNorm skeleton is `models/gpt.py`'s, reached through its factory
hooks (`GPTBlock.mlp_cls`, `GPTModel.block_cls`,
`GPTForPretraining.model_cls`); every block's dense MLP becomes a routed
`MoEFFN`. The training loss adds the routers' aux and z losses, and
`collect_moe_stats` hands the routing health to `jit.TrainStep`.
`GPTForPretraining.init_weights` draws w_gate, w_in and w_out from
N(0, initializer_range), as the JAX MoEFFN's initialiser does.

Under a mesh the LM loss is this rank's share of the global mean
(`models.gpt._mesh_mean`); the layers' aux and z (and the five `moe.*`
gauges) are already means over ep (`moe/layer.py`), and under an sp
axis above 1 they take the same 1/sp share as the LM loss, since
`ShardedTrainStep` sums the gradients over sp.
"""
from ..distributed import env as dist_env
from ..models.gpt import GPTBlock, GPTConfig, GPTForPretraining, GPTModel
from .layer import MoEFFN

__all__ = ["GPTMoEConfig", "GPTMoEBlock", "GPTMoEModel", "GPTMoE",
           "gpt_moe_tiny_config"]


class GPTMoEConfig(GPTConfig):
    """GPTConfig plus the MoE knobs, with the JAX package's defaults."""

    def __init__(self, num_experts=8, expert_top_k=2,
                 capacity_factor=1.25, aux_loss_weight=0.01,
                 z_loss_weight=1e-3, **kw):
        super().__init__(**kw)
        self.num_experts = int(num_experts)
        self.expert_top_k = int(expert_top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_loss_weight = float(aux_loss_weight)
        self.z_loss_weight = float(z_loss_weight)


class GPTMoEBlock(GPTBlock):
    mlp_cls = MoEFFN


class GPTMoEModel(GPTModel):
    block_cls = GPTMoEBlock


class GPTMoE(GPTForPretraining):
    """GPT pretraining head over MoE blocks. loss() = LM loss +
    aux_loss_weight * mean-over-layers aux + z_loss_weight * mean z."""

    model_cls = GPTMoEModel

    @property
    def moe_num_experts(self):
        return self.config.num_experts

    def _moe_layers(self):
        return [b.mlp for b in self.gpt.blocks if isinstance(b.mlp, MoEFFN)]

    def loss(self, input_ids, labels, loss_mask=None):
        lm = super().loss(input_ids, labels, loss_mask)
        auxes = [m.aux_loss() for m in self._moe_layers()]
        zs = [m.z_loss() for m in self._moe_layers()]
        if not auxes or auxes[0] is None:
            return lm
        c = self.config
        n = float(len(auxes))
        share = 1.0 / (n * dist_env.axis_size("sp"))
        aux = sum(auxes[1:], auxes[0]) * share
        z = sum(zs[1:], zs[0]) * share
        return lm + c.aux_loss_weight * aux + c.z_loss_weight * z

    def collect_moe_stats(self):
        """Mean routing-health vector (5,) over the MoE layers of the LAST
        forward (router.STATS_FIELDS order); None before any forward."""
        stats = [m.stats() for m in self._moe_layers()]
        if not stats or stats[0] is None:
            return None
        return sum(stats[1:], stats[0]) / float(len(stats))


def gpt_moe_tiny_config(**kw):
    """Small MoE config for tests (the JAX package's: the composed
    attention)."""
    defaults = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=128, dropout=0.0,
                    num_experts=4, expert_top_k=2, capacity_factor=2.0,
                    use_flash_attention=False)
    defaults.update(kw)
    return GPTMoEConfig(**defaults)
