"""Every name of the JAX package has its counterpart in the port.

The JAX package's sources are parsed with ``ast`` (never imported): every
top-level function and class of ``mre_tpu/**/*.py`` and every method of a
top-level class must exist in the port module of the same path under
``mre_tpu_torch/`` (``MODULES`` maps the few that moved), under the same
name, under a flax → torch name (``__call__`` → ``forward``, ``setup`` →
``__init__``), under a name ``RENAMED`` gives (checked to exist), or stand
in ``EXEMPT`` with the reason it has no counterpart. Helpers nested inside a
function are not compared: they are not part of a module's surface. A new
JAX name without a counterpart, or an entry here that no longer names a
JAX name, fails.
"""

import ast
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "mre_tpu", REPO / "mre_tpu_torch"

# JAX module → port module, where the path differs
MODULES = {
    "ops/pallas/attention.py": "ops/attention.py",
    "openke/native/__init__.py": "openke/native.py",
}

# flax module methods → their torch.nn.Module counterparts
FLAX_NAMES = {"__call__": ("forward", "__call__"), "setup": ("__init__",)}

# (JAX module, name) → (port module, name)
RENAMED = {
    ("data/multimodal.py", "_decode_image"): ("data/images.py", "decode_png"),
    ("models/extractor.py", "Extractor._neighbor_encoder"):
        ("models/extractor.py", "Extractor.encode_neighbors"),
    ("models/transformer.py", "DropPath"): ("models/transformer.py", "DropoutMasks"),
    ("models/transformer.py", "DropPath.__call__"):
        ("models/transformer.py", "DropoutMasks.path"),
    ("models/unified.py", "UnifiedModel.init_all"): ("models/initializers.py", "init_weights"),
    ("openke/data.py", "TrainDataLoader._sample_jax"):
        ("openke/data.py", "TrainDataLoader._sample_torch"),
    ("ops/pallas/attention.py", "_attention_reference"):
        ("ops/attention.py", "attention_reference"),
    ("ops/pallas/attention.py", "_fwd"): ("ops/attention.py", "FusedAttention.forward"),
    ("ops/pallas/attention.py", "_bwd"): ("ops/attention.py", "FusedAttention.backward"),
    ("train/fusion.py", "FusionTrainer._build_step"): ("train/fusion.py", "FusionTrainer.step"),
    ("train/kge.py", "KGETrainer._build_step"): ("train/kge.py", "KGETrainer.step_with_batch"),
    ("zsl/module.py", "ZSLModule._generate"): ("train/fusion.py", "FusionTrainer.generate"),
    ("zsl/module.py", "ZSLModule._run_d_step"): ("zsl/module.py", "ZSLModule.d_step"),
    ("zsl/module.py", "ZSLModule._make_g_step"): ("zsl/module.py", "ZSLModule.g_step"),
}

_KERNEL = "a Pallas body or its TPU layout helper: ops/attention.py + csrc/attention_fwd.cu"
_JIT = "a jax.jit wrapper of a module method, which the port calls directly"
EXEMPT = {
    ("core/rng.py", "RngStream"): "explicit torch.Generators, and draws passed as arguments",
    ("core/rng.py", "RngStream.__init__"): "explicit torch.Generators",
    ("core/rng.py", "RngStream.next"): "explicit torch.Generators",
    ("core/rng.py", "RngStream.next_n"): "explicit torch.Generators",
    ("data/kg.py", "_kg_flatten"): "JAX pytree registration of DeviceKG",
    ("data/kg.py", "_kg_unflatten"): "JAX pytree registration of DeviceKG",
    ("models/kge.py", "_simple_all_heads"):
        "the DistMult-form fast paths (values compared in test_torch_port_kge_models.py)",
    ("models/kge.py", "_simple_all_tails"):
        "the DistMult-form fast paths (values compared in test_torch_port_kge_models.py)",
    ("models/transformer.py", "_pallas_attention_available"): 'fused_attention(impl="auto")',
    ("ops/pallas/attention.py", "pallas_attention_profitable"): 'fused_attention(impl="auto")',
    ("ops/pallas/attention.py", "_attention_kernel"): _KERNEL,
    ("ops/pallas/attention.py", "_attention_kernel_packed"): _KERNEL,
    ("ops/pallas/attention.py", "_pallas_forward"): _KERNEL,
    ("ops/pallas/attention.py", "_packed_pack"): _KERNEL,
    ("ops/pallas/attention.py", "_head_group"): _KERNEL,
    ("ops/pallas/attention.py", "_round_up"): _KERNEL,
    ("train/kge.py", "torch_adagrad"): "torch.optim.Adagrad itself",
    ("train/fusion.py", "FusionTrainer._dummy_batch"):
        "flax's shape-driven init; the port builds its modules eagerly (init_weights)",
    ("train/fusion.py", "FusionTrainer._init_variables"):
        "flax's shape-driven init; the port builds its modules eagerly (init_weights)",
    ("train/fusion.py", "FusionTrainer._shard_batch"):
        "XLA sharding annotations; the port splits rows with parallel/mesh.py row_shard",
    ("train/fusion.py", "FusionTrainer._encode_cls_jit"): _JIT,
    ("train/fusion.py", "FusionTrainer._gcn_jit"): _JIT,
    ("train/fusion.py", "FusionTrainer._rel_encode_jit"): _JIT,
    ("train/fusion.py", "FusionTrainer._generate_jit"): _JIT,
    ("zsl/module.py", "ZSLModule._build_steps"):
        "builds the jitted steps; the port's are the eager pretrain_step / d_step / g_step",
    ("zsl/module.py", "ZSLModule._next_key"): "JAX key splitting; the port's torch.Generator",
    ("zsl/module.py", "ZSLModule._split_g"):
        "flax parameter-dict split of the generator head; the port's G optimizer holds the "
        "head's parameters (reset_g_optimizer)",
    ("zsl/module.py", "ZSLModule._merge_g"):
        "flax parameter-dict merge of the generator head (see _split_g)",
}


def surface(path: Path) -> set:
    """Top-level functions and classes, and the methods of top-level classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return out


def port_module(rel: str) -> str:
    return MODULES.get(rel, rel)


def _port_surface(rel: str) -> set:
    path = PORT / rel
    return surface(path) if path.exists() else set()


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def missing(rel: str) -> list:
    """The JAX names of module ``rel`` with no counterpart and no exemption."""
    have = _port_surface(port_module(rel))
    out = []
    for name in sorted(surface(JAX / rel)):
        if (rel, name) in EXEMPT:
            continue
        if (rel, name) in RENAMED:
            mod, new = RENAMED[(rel, name)]
            if new not in _port_surface(mod):
                out.append(f"{name} (renamed to {mod}::{new}, which is missing)")
            continue
        cls, _, meth = name.rpartition(".")
        alts = [name] + [f"{cls}.{a}" for a in FLAX_NAMES.get(meth, ())] if cls else [name]
        if not any(a in have for a in alts):
            out.append(name)
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_name_has_a_port_counterpart(rel):
    assert missing(rel) == [], f"mre_tpu/{rel}: no counterpart in mre_tpu_torch/{port_module(rel)}"


def test_every_exemption_names_a_jax_name_and_gives_a_reason():
    for table in (EXEMPT, RENAMED):
        for rel, name in table:
            assert name in surface(JAX / rel), f"stale entry: mre_tpu/{rel}::{name}"
    assert all(reason.strip() for reason in EXEMPT.values())
    assert not set(EXEMPT) & set(RENAMED)


def test_the_learnability_slice_is_covered():
    """The names this slice ported: the learnable fixture, the ExpModel
    batch, and the learnability driver's entry point."""
    assert {"write_learnable_zsl_dataset", "_TYPE_WORDS"} <= (
        _port_surface("data/fixtures.py")
        | {t.id for n in ast.parse((PORT / "data/fixtures.py").read_text()).body
           if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)})
    assert "MultimodalStore.triple_batch" in _port_surface("data/multimodal.py")
    assert {"main", "certify"} <= surface(PORT / "tools/zsl_learnability.py")
    assert "main" in surface(REPO / "experiments/zsl_learnability.py")


def test_a_missing_name_is_reported(monkeypatch):
    """The check fails for a JAX name whose counterpart is gone."""
    real = surface
    monkeypatch.setattr(sys.modules[__name__], "_port_surface",
                        lambda rel: real(PORT / rel) - {"MultimodalStore.triple_batch"})
    assert missing("data/multimodal.py") == ["MultimodalStore.triple_batch"]
