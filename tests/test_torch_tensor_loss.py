"""The tensor and expert axes' tables and refusals in the port:

- the mesh: ``logical_axis_rules`` is ``tpufw``'s table; ``mesh_shape``
  and ``rank_grid`` give ``expert`` and ``tensor`` dimensions laid out as
  ``tpufw``'s devices (``tests/test_mesh.py``'s shapes); ``split_specs``
  gives the splits the rules imply, and ``cut_model`` each coordinate
  its part;
- the vocab-parallel cross-entropy equals ``chunked_cross_entropy`` in
  value and gradient, with the z-loss and Gemma's final soft cap, at
  tensor 2 and 4;
- the divisibility ``ValueError``s name the dimension and the axis;
- every path not ported to the axes yet raises ``NotImplementedError``
  naming ROADMAP.md Queue 1 item 12g.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.mesh import build_mesh as j_build_mesh
from tpufw.mesh import logical_axis_rules as j_rules
from tpufw_torch.mesh import (
    MeshConfig,
    logical_axis_rules,
    mesh_shape,
    rank_grid,
)
from tpufw_torch.models import PRESETS
from tpufw_torch.ops.loss import chunked_cross_entropy
from tpufw_torch.parallel import LocalExpertGroup, LocalTensorGroup
from tpufw_torch.parallel.tensor import check_divisible, cut_model
from tpufw_torch.train import Trainer, TrainerConfig

ITEM = r"item 12g\)$"


def test_logical_axis_rules_are_tpufws():
    assert logical_axis_rules() == j_rules()


@pytest.mark.parametrize("kw,shape", [
    ({"fsdp": 2, "tensor": 4}, {"data": 1, "fsdp": 2, "sequence": 1,
                                "tensor": 4}),
    ({"fsdp": 2, "expert": 4}, {"data": 1, "fsdp": 2, "expert": 4,
                                "sequence": 1}),
    ({"data": 2, "fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 2,
                                           "sequence": 1, "tensor": 2}),
    ({"fsdp": 1, "expert": 4, "tensor": 2}, {"data": 1, "fsdp": 1,
                                             "expert": 4, "sequence": 1,
                                             "tensor": 2}),
])
def test_mesh_shape_has_expert_and_tensor_dims(devices8, kw, shape):
    """The dimensions in ``tpufw``'s axis order, the ranks laid out as its
    devices are."""
    assert mesh_shape(MeshConfig(**kw), 8) == shape
    jmesh = j_build_mesh(JMeshConfig(**kw))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(rank_grid(MeshConfig(**kw), 8), ids)
    assert {k: v for k, v in jmesh.shape.items() if v > 1} == {
        k: v for k, v in shape.items() if v > 1}


# Per preset: {parameter: its split} for one layer's parameters and the
# model's own, as the rules lay ``tpufw``'s logical axes out; every other
# parameter of the layer is replicated over both axes.
_SPLITS = {
    "llama3_tiny": {
        "embed": (("tensor", 0),), "lm_head": (("tensor", 0),),
        "layers.0.attn.q.weight": (("tensor", 0),),
        "layers.0.attn.k.weight": (("tensor", 0),),
        "layers.0.attn.v.weight": (("tensor", 0),),
        "layers.0.attn.o.weight": (("tensor", 1),),
        "layers.0.mlp.gate.weight": (("tensor", 0),),
        "layers.0.mlp.up.weight": (("tensor", 0),),
        "layers.0.mlp.down.weight": (("tensor", 1),),
    },
    "mixtral_tiny": {
        # Llama's attention; an expert stack [E, out, in]: experts over
        # expert, the width over tensor; the router replicated.
        "layers.0.attn.q.weight": (("tensor", 0),),
        "layers.0.attn.k.weight": (("tensor", 0),),
        "layers.0.attn.v.weight": (("tensor", 0),),
        "layers.0.attn.o.weight": (("tensor", 1),),
        "layers.0.moe.w_gate": (("expert", 0), ("tensor", 1)),
        "layers.0.moe.w_up": (("expert", 0), ("tensor", 1)),
        "layers.0.moe.w_down": (("expert", 0), ("tensor", 2)),
    },
    "deepseek_tiny": {
        # MLA: the query and the latent kernel [kvr, heads, head_dim] on
        # the heads, the latent down-projection replicated; a dense MLP.
        "layers.0.attn.q.weight": (("tensor", 0),),
        "layers.0.attn.kv_b_kernel": (("tensor", 1),),
        "layers.0.attn.o.weight": (("tensor", 1),),
        "layers.0.mlp.gate.weight": (("tensor", 0),),
        "layers.0.mlp.up.weight": (("tensor", 0),),
        "layers.0.mlp.down.weight": (("tensor", 1),),
    },
}


@pytest.mark.parametrize("preset", sorted(_SPLITS))
def test_split_specs_follow_the_rules(preset):
    from tpufw_torch.models import model_for_config
    from tpufw_torch.parallel.tensor import split_specs

    model = model_for_config(PRESETS[preset], device="meta")
    specs = split_specs(model)
    want = _SPLITS[preset]
    assert {k: v for k, v in specs.items() if k in want} == want
    layer0 = {k for k, _ in model.named_parameters()
              if k.startswith("layers.0.")}
    assert layer0 & set(specs) == layer0 & set(want)
    for k, split in specs.items():
        assert all(axis in ("expert", "tensor") for axis, _ in split), k


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("z,cap", [(1e-4, None), (0.0, None), (1e-4, 30.0)])
def test_vocab_parallel_ce_equals_chunked(tp, z, cap):
    g = torch.Generator().manual_seed(0)
    h = torch.randn(3, 11, 16, generator=g)
    k = torch.randn(16, 64, generator=g) * 2.0
    t = torch.randint(0, 64, (3, 11), generator=g)
    m = (torch.rand(3, 11, generator=g) > 0.2).float()
    kw = dict(z_loss_weight=z, chunk_size=4, compute_dtype=torch.float32,
              logits_soft_cap=cap)
    outs = []
    for group in (None, LocalTensorGroup(tp)):
        hh, kk = h.clone().requires_grad_(), k.clone().requires_grad_()
        loss, n = chunked_cross_entropy(hh, kk, t, m, group=group, **kw)
        loss.backward()
        outs.append((loss.detach(), n, hh.grad, kk.grad))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("preset,over,tp,ep,match", [
    ("llama3_tiny", {"n_heads": 6, "n_kv_heads": 2}, 4, 1,
     "tensor=4 must divide n_heads=6"),
    ("llama3_tiny", {"n_kv_heads": 1}, 2, 1,
     "tensor=2 must divide n_kv_heads=1"),
    ("llama3_tiny", {"d_ff": 129}, 2, 1, "tensor=2 must divide d_ff=129"),
    ("llama3_tiny", {"vocab_size": 255}, 2, 1,
     "tensor=2 must divide vocab_size=255"),
    ("deepseek_moe_tiny", {"moe_d_ff": 50}, 4, 1,
     "tensor=4 must divide moe_d_ff=50"),
    ("mixtral_tiny", {}, 1, 3, "expert=3 must divide n_experts=4"),
    ("llama3_tiny", {}, 1, 2, "has no experts to shard"),
])
def test_indivisible_splits_raise(preset, over, tp, ep, match):
    cfg = dataclasses.replace(PRESETS[preset], **over)
    with pytest.raises(ValueError, match=match):
        check_divisible(cfg, tp, ep)
    groups = tuple(g for g in (LocalTensorGroup(tp), LocalExpertGroup(ep))
                   if g.size > 1)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, TrainerConfig(batch_size=2, seq_len=9), device="cpu",
                groups=groups)


@pytest.mark.parametrize("preset", ["mixtral_tiny", "deepseek_tiny"])
def test_cut_model_cuts_each_coordinate(preset):
    """``cut_model`` gives each (expert, tensor) coordinate its part; the
    parts put back together along the split dims are the whole state,
    and the replicated tensors are whole on every coordinate."""
    import copy

    from tpufw_torch.models import model_for_config
    from tpufw_torch.parallel import ProcessExpertGroup, ProcessTensorGroup

    cfg = PRESETS[preset]
    model = model_for_config(cfg, device="cpu")
    whole = model.state_dict()
    ep = 2 if getattr(cfg, "n_experts", 0) else 1
    parts = {}
    for e in range(ep):
        for t in range(2):
            m = copy.deepcopy(model)
            specs = cut_model(m, (ProcessExpertGroup(None, ep, e),
                                  ProcessTensorGroup(None, 2, t)))
            parts[e, t] = m.state_dict()
    assert parts[0, 0]["embed"].shape[0] == cfg.vocab_size // 2
    for k, v in whole.items():
        dims = dict(specs.get(k, ()))
        rows = [torch.cat([parts[e, t][k] for t in range(2)],
                          dims["tensor"]) if "tensor" in dims
                else parts[e, 0][k] for e in range(ep)]
        got = torch.cat(rows, dims["expert"]) if "expert" in dims \
            else rows[-1]
        assert torch.equal(got, v), k
        if "tensor" not in dims:
            assert all(torch.equal(parts[e, 0][k], parts[e, 1][k])
                       for e in range(ep)), k


def _post_trainer(name):
    from tpufw_torch import train

    return {"dpo": train.DPOTrainer, "distill": train.DistillTrainer,
            "grpo": train.GRPOTrainer,
            "embed": train.EmbeddingTrainer}[name]


@pytest.mark.parametrize("case", [
    "lora", "lora_forward", "lora_moe_forward", "int8_forward",
    "sorted_expert", "vision", "mesh_sequence",
])
def test_unported_paths_name_item_12g(case, monkeypatch):
    """Each path the axes do not reach yet refuses them, naming 12g, in
    the trainers and, for a model driven under the groups directly, in
    the split modules (LoRA adapters, int8 weights); the sorted dispatch
    refuses a resolved expert axis in ``tpufw``'s words."""
    tcfg = TrainerConfig(batch_size=2, seq_len=9)
    tp2 = (LocalTensorGroup(2),)
    for k in [k for k in __import__("os").environ if k.startswith("TPUFW_")]:
        monkeypatch.delenv(k)
    if case == "lora":
        cfg = dataclasses.replace(PRESETS["llama3_tiny"], lora_rank=4)
        with pytest.raises(NotImplementedError, match=ITEM):
            Trainer(cfg, tcfg, device="cpu", groups=tp2)
    elif case.endswith("_forward"):
        from tpufw_torch.models import model_for_config
        from tpufw_torch.parallel.context import use_groups

        preset, over, groups = {
            "lora_forward": ("llama3_tiny", {"lora_rank": 4}, tp2),
            "lora_moe_forward": ("mixtral_tiny", {"lora_rank": 4},
                                 (None, LocalExpertGroup(2))),
            "int8_forward": ("llama3_tiny", {"quantized_weights": True},
                             tp2),
        }[case]
        cfg = dataclasses.replace(PRESETS[preset], **over)
        model = model_for_config(cfg, device="cpu")
        what = "int8 weights" if "int8" in case else "LoRA adapters"
        with use_groups(*groups), pytest.raises(
                NotImplementedError, match=f"with {what} .*{ITEM}"):
            model(torch.zeros(1, 4, dtype=torch.long))
    elif case == "sorted_expert":
        cfg = dataclasses.replace(PRESETS["mixtral_tiny"],
                                  moe_dispatch="sorted")
        with pytest.raises(ValueError, match="cannot shard the expert"):
            Trainer(cfg, tcfg, device="cpu", groups=(LocalExpertGroup(2),))
    elif case == "vision":
        from tpufw_torch.models import VIT_CONFIGS
        from tpufw_torch.train import VisionTrainer, VisionTrainerConfig

        with pytest.raises(NotImplementedError, match=ITEM):
            VisionTrainer(VIT_CONFIGS["vit_s16"], VisionTrainerConfig(),
                          MeshConfig(tensor=2, fsdp=1), device="cpu")
    elif case == "mesh_sequence":
        with pytest.raises(NotImplementedError, match=ITEM):
            mesh_shape(MeshConfig(sequence=2, fsdp=1, tensor=2), 4)


@pytest.mark.parametrize("case", [
    "dpo", "distill", "grpo", "embed", "pipeline_trainer", "mesh_pipe",
    "rl_workload", "batch_env", "pipeline_env",
])
def test_lifted_paths_take_the_axes(case, monkeypatch):
    """The paths that refused the axes naming 12g until items 12g-1 and
    12g-2 take them: the post-trainers (their log-prob, KL and pooling
    heads over the shards), the pipeline trainer and mesh (tensor and
    expert inside the stages), and the ``rl``, ``embed`` and
    ``train_pipeline`` knobs."""
    tcfg = TrainerConfig(batch_size=2, seq_len=9)
    for k in [k for k in __import__("os").environ if k.startswith("TPUFW_")]:
        monkeypatch.delenv(k)
    if case in ("dpo", "distill", "grpo", "embed"):
        from tpufw_torch.train import GRPOConfig

        cls = _post_trainer(case)
        kw = {"grpo": GRPOConfig(group_size=2)} if case == "grpo" else {}
        tr = cls(PRESETS["llama3_tiny"], tcfg, device="cpu",
                 groups=(LocalTensorGroup(2),), **kw)
        assert [g.size for g in tr.groups] == [2, 1] and tr.split
    elif case == "pipeline_trainer":
        from tpufw_torch.parallel.pipeline import PipelineConfig
        from tpufw_torch.train import PipelineTrainer

        tr = PipelineTrainer(PRESETS["llama3_tiny"], PipelineConfig(2, 2),
                             TrainerConfig(batch_size=4, seq_len=9),
                             MeshConfig(pipe=2, fsdp=1, tensor=2),
                             device="cpu")
        assert [(g.axis, g.size, g.holds_all) for g in tr.groups] == [
            ("tensor", 2, True), ("expert", 1, True)]
    elif case == "mesh_pipe":
        assert mesh_shape(MeshConfig(pipe=2, fsdp=1, expert=2), 4) == {
            "data": 1, "pipe": 2, "fsdp": 1, "expert": 2, "sequence": 1}
    else:
        from tpufw_torch.workloads import env

        monkeypatch.setenv("TPUFW_MESH_TENSOR", "2")
        if case == "pipeline_env":
            assert env.mesh_from_env(8, pipe=2) == MeshConfig(
                pipe=2, fsdp=-1, tensor=2)
        elif case == "rl_workload":
            from tpufw_torch.workloads import rl

            # Outside a gang the Trainer's mesh-fit check, as for any
            # axis that does not fit one device.
            monkeypatch.setenv("TPUFW_DEVICE", "cpu")
            with pytest.raises(ValueError, match="1 devices not divisible"):
                rl.build_trainer()
        else:
            assert env.batch_mesh_from_env() == MeshConfig(
                data=1, fsdp=-1, tensor=2)
