"""The PyTorch port stands alone: it imports neither jax nor any ``repro``
module, not even a jax-free one."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "flash_variants.py",
                                 "decode_variants.py", "cosine_variants.py",
                                 "ivf_variants.py", "masked_variants.py",
                                 "variant_harness.py", "train_turns.py")]
    assert len(files) > 10
    return files


def _modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    bad = [m for m in _modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_tenancy_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"tenancy/partition.py", "tenancy/registry.py",
            "tenancy/__init__.py", "serving/loadgen.py"} <= names


def test_ivf_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"kernels/ivf_topk.py", "core/index.py"} <= names


def test_model_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"configs/__init__.py", "configs/base.py", "configs/yi_6b.py",
            "models/__init__.py", "models/layers.py", "models/attention.py",
            "models/model.py", "models/convert.py",
            "kernels/flash_attention.py",
            "kernels/decode_attention.py"} <= names
    assert len([n for n in names if n.startswith("configs/")]) == 12


def test_quant_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"kernels/cosine_topk.py", "kernels/ops.py", "kernels/ref.py",
            "kernels/build.py"} <= names


def test_async_serving_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"obs/__init__.py", "obs/trace.py", "obs/explain.py",
            "obs/export.py", "embedding/lsh.py", "serving/resilience.py",
            "serving/scheduler.py", "serving/server.py",
            "serving/loadgen.py"} <= names


def test_sessions_bands_resilience_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"context/__init__.py", "context/fusion.py", "context/session.py",
            "generative/__init__.py", "generative/policy.py",
            "generative/synthesize.py", "serving/resilience.py"} <= names


def test_sharded_cache_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"core/distributed.py", "core/__init__.py",
            "training/checkpoint.py", "serving/engine.py"} <= names


def test_model_families_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"models/moe.py", "models/ssm.py", "models/model.py",
            "models/layers.py", "models/convert.py",
            "kernels/flash_attention.py"} <= names


def test_training_and_modalities_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"data/audio_delay.py", "training/optimizer.py",
            "training/__init__.py", "launch/train.py", "models/layers.py",
            "models/model.py", "kernels/ops.py", "kernels/ref.py"} <= names


def test_last_modules_slice_files_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"embedding/encoder.py", "embedding/__init__.py", "core/hnsw.py",
            "core/__init__.py", "launch/roofline.py", "launch/sharding.py",
            "launch/dryrun.py", "models/convert.py",
            "models/model.py"} <= names


def test_dryrun_import_sets_no_environment_variable():
    """The reference's dry run sets ``XLA_FLAGS`` when imported; the
    port's changes nothing in the environment."""
    code = ("import os\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert dict(os.environ) == before, set(os.environ) ^ set(before)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.serving\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.training.checkpoint, repro_torch.launch.serve\n"
        "import repro_torch.tenancy, repro_torch.serving.loadgen\n"
        "import repro_torch.kernels.ivf_topk\n"
        "from repro_torch.core import IVFIndex, IVFState\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "from repro_torch.serving import ModelBackend\n"
        "from repro_torch.kernels.cosine_topk import (quantize_keys,\n"
        "    quant_cosine_topk_cuda, quant_cosine_topk_interval_cuda,\n"
        "    quant_cosine_topk_masked_cuda)\n"
        "from repro_torch.kernels.ops import quant_cosine_topk\n"
        "from repro_torch.kernels.ref import (quant_cosine_topk_ref,\n"
        "    quant_cosine_topk_interval_ref)\n"
        "import repro_torch.obs, repro_torch.embedding.lsh\n"
        "from repro_torch.serving import (AsyncCacheServer, AsyncScheduler,\n"
        "    Overloaded, run_waves)\n"
        "import repro_torch.generative\n"
        "from repro_torch.context import (AttentionFusion, DecayMeanFusion,\n"
        "    SessionStore)\n"
        "from repro_torch.generative import BandPolicy, TemplateSplice\n"
        "from repro_torch.serving import (FaultyBackend, ResilienceConfig,\n"
        "    build_multi_turn_workload, run_sessions)\n"
        "from repro_torch.core import (DistributedCache, ShardMesh,\n"
        "    make_mesh, shard_axes)\n"
        "from repro_torch.training.checkpoint import (load_checkpoint_flat,\n"
        "    reshard_runtime)\n"
        "from repro_torch.models.moe import dispatch_indices, moe_ffn, router\n"
        "from repro_torch.models.ssm import (SSMState, ssd_scan,\n"
        "    ssm_decode_step, ssm_forward)\n"
        "from repro_torch.data.audio_delay import apply_delay, remove_delay\n"
        "from repro_torch.models.layers import apply_mrope, positionize\n"
        "from repro_torch.training.optimizer import (AdamWConfig,\n"
        "    adamw_update, init_adamw, make_train_step)\n"
        "from repro_torch.launch.train import make_batches, train\n"
        "from repro_torch.kernels.ops import FlashAttention\n"
        "from repro_torch.kernels.flash_attention import (\n"
        "    flash_attention_bwd_cuda, flash_attention_fwd_cuda)\n"
        "from repro_torch.kernels.ref import (flash_attention_bwd_ref,\n"
        "    flash_attention_lse_ref)\n"
        "from repro_torch.embedding import (EncoderConfig, MINILM_L6,\n"
        "    encode, init_encoder_params)\n"
        "from repro_torch.core import HNSWIndex\n"
        "from repro_torch.models.convert import tree_from_jax\n"
        "from repro_torch.launch import dryrun, roofline, sharding\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------------------- #
# the reference's public names, read with ast (no jax import)
REFERENCE = ROOT / "src" / "repro"


def _reference_exports() -> dict[str, list[str]]:
    """Each reference package's ``__all__``, or, where it has none, its
    public top-level names (imports, definitions, assignments)."""
    out = {}
    for init in sorted(REFERENCE.glob("*/__init__.py")):
        tree = ast.parse(init.read_text(), filename=str(init))
        names = None
        public = []
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets
                           if isinstance(t, ast.Name)]
                if "__all__" in targets:
                    names = list(ast.literal_eval(node.value))
                public += targets
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                public.append(node.target.id)
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                public.append(node.name)
            elif isinstance(node, ast.ImportFrom) and \
                    node.module != "__future__":
                public += [a.asname or a.name for a in node.names]
        out[init.parent.name] = names if names is not None else [
            n for n in public if not n.startswith("_")]
    return out


def _port_name(name: str) -> str:
    """The port's counterpart of a reference name: a ``*_pallas`` kernel
    is the port's ``*_cuda`` wrapper, anything else keeps its name."""
    return name[:-len("_pallas")] + "_cuda" if name.endswith("_pallas") \
        else name


REFERENCE_EXPORTS = _reference_exports()


@pytest.mark.parametrize("package", sorted(REFERENCE_EXPORTS))
def test_port_exports_the_reference_public_names(package):
    import importlib
    names = REFERENCE_EXPORTS[package]
    assert names, package
    mod = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in names if not hasattr(mod, _port_name(n))]
    assert not missing, f"repro_torch.{package} lacks {missing}"
    if hasattr(mod, "__all__"):
        unlisted = [n for n in names if _port_name(n) not in mod.__all__]
        assert not unlisted, f"repro_torch.{package}.__all__ lacks {unlisted}"
