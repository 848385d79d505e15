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
- the paths item 12g lifted take the axes, and the splits refused by
  design (int8 weights) or in ``tpufw``'s words (the sorted dispatch on
  an expert axis) still raise.
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


@pytest.mark.parametrize("case", ["int8_forward", "sorted_expert"])
def test_unported_paths_name_item_12g(case, monkeypatch):
    """The splits that stay refused now that item 12g is closed (their
    refusals named it until then): int8 weights under a split, by design
    (a serving form; serving runs unsplit), for a model driven under the
    groups directly; and the sorted dispatch on a resolved expert axis,
    in ``tpufw``'s words."""
    tcfg = TrainerConfig(batch_size=2, seq_len=9)
    for k in [k for k in __import__("os").environ if k.startswith("TPUFW_")]:
        monkeypatch.delenv(k)
    if case == "int8_forward":
        from tpufw_torch.models import model_for_config
        from tpufw_torch.parallel.context import use_groups

        cfg = dataclasses.replace(PRESETS["llama3_tiny"],
                                  quantized_weights=True)
        model = model_for_config(cfg, device="cpu")
        with use_groups(LocalTensorGroup(2)), pytest.raises(
                NotImplementedError, match=r"^a QuantProjection with int8 "
                r"weights split over \{'tensor': 2\}: int8 weights are a "
                r"serving form, and serving runs unsplit") as got:
            model(torch.zeros(1, 4, dtype=torch.long))
        assert "12g" not in str(got.value)
    else:
        cfg = dataclasses.replace(PRESETS["mixtral_tiny"],
                                  moe_dispatch="sorted")
        with pytest.raises(ValueError, match="cannot shard the expert"):
            Trainer(cfg, tcfg, device="cpu", groups=(LocalExpertGroup(2),))


def _lora_forward(preset, groups):
    """(split, unsplit) logits of ``preset`` with rank-4 adapters (B drawn
    nonzero) under one process's ``groups``."""
    from tpufw_torch.models import model_for_config
    from tpufw_torch.parallel.context import use_groups

    cfg = dataclasses.replace(PRESETS[preset], lora_rank=4,
                              dtype=torch.float32)
    model = model_for_config(cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("_lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    with torch.no_grad():
        want = model(tokens)
        with use_groups(**{g.axis: g for g in groups}):
            got = model(tokens)
    return got, want


@pytest.mark.parametrize("case", [
    "dpo", "distill", "grpo", "embed", "pipeline_trainer", "mesh_pipe",
    "rl_workload", "batch_env", "pipeline_env", "lora", "lora_forward",
    "lora_moe_forward", "vision", "mesh_sequence",
])
def test_lifted_paths_take_the_axes(case, monkeypatch):
    """The paths that refused the axes naming 12g until items 12g-1,
    12g-2 and 12g-3 take them: the post-trainers (their log-prob, KL and
    pooling heads over the shards), the pipeline trainer and mesh (tensor
    and expert inside the stages), the ``rl``, ``embed`` and
    ``train_pipeline`` knobs; LoRA under the split (the trainer, and a
    model driven under the groups: the adapters ride their weights'
    shards), the vision trainer under ``tensor``, and the model axes
    beside a ``sequence`` axis in a mesh's shape."""
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
    elif case == "lora":
        cfg = dataclasses.replace(PRESETS["llama3_tiny"], lora_rank=4,
                                  dtype=torch.float32)
        tr = Trainer(cfg, tcfg, device="cpu", groups=(LocalTensorGroup(2),))
        assert [g.size for g in tr.groups] == [2, 1] and tr.split
        tr.init_state(seed=0)
        tokens = np.random.default_rng(0).integers(0, 256, (2, 9))
        m = tr.train_step({"tokens": tokens.astype(np.int32)})
        assert np.isfinite(float(m["loss"]))
    elif case in ("lora_forward", "lora_moe_forward"):
        got, want = _lora_forward(*{
            "lora_forward": ("llama3_tiny", (LocalTensorGroup(2),)),
            "lora_moe_forward": ("mixtral_tiny", (LocalExpertGroup(2),
                                                  LocalTensorGroup(2))),
        }[case])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    elif case == "vision":
        from tpufw_torch.models import VIT_CONFIGS
        from tpufw_torch.train import VisionTrainer, VisionTrainerConfig

        tr = VisionTrainer(VIT_CONFIGS["vit_s16"], VisionTrainerConfig(),
                           MeshConfig(tensor=2, fsdp=1), device="cpu")
        assert [(g.axis, g.size) for g in tr.groups] == [
            ("tensor", 2), ("expert", 1)]
    elif case == "mesh_sequence":
        # tpufw's axis order: expert before sequence before tensor.
        for axis, order in (("tensor", ["sequence", "tensor"]),
                            ("expert", ["expert", "sequence"])):
            shape = mesh_shape(MeshConfig(sequence=2, fsdp=1, **{axis: 2}),
                               4)
            assert list(shape.items()) == [("data", 1), ("fsdp", 1)] + [
                (a, 2) for a in order]
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
