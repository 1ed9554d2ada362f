"""The PyTorch port stands alone: no JAX and nothing of ``repro``.

An AST walk over every module of ``src/repro_torch`` and over
``chip_smoke.py`` finds no import of ``jax`` or of the JAX package, and a
fresh interpreter in which ``jax`` and ``repro`` cannot be imported still
imports the port's entry points.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_has_modules_and_smoke_script():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"__init__.py", "core/layering.py", "core/progressive.py",
            "kernels/ops.py", "kernels/layered_matmul.py",
            "kernels/flash_attention.py", "kernels/ssd_scan.py",
            "configs/base.py", "configs/registry.py", "models/layers.py",
            "models/ssm.py", "models/transformer.py", "models/convert.py",
            "models/rglru.py", "models/moe.py", "configs/yi_6b.py",
            "configs/glm4_9b.py", "configs/starcoder2_7b.py",
            "configs/recurrentgemma_9b.py", "configs/qwen2_moe_a2_7b.py",
            "configs/llama4_maverick_400b_a17b.py",
            "runtime/master.py", "runtime/gateway.py",
            "runtime/transport/cuda_device.py", "launch/serve.py",
            "configs/whisper_tiny.py", "configs/internvl2_1b.py",
            "models/loss.py", "optim/optimizers.py", "data/pipeline.py",
            "checkpoint/store.py", "launch/steps.py", "launch/train.py",
            "tree.py", "runtime/trace_export.py",
            "runtime/transport/process.py", "runtime/transport/shm.py",
            "runtime/transport/socket_host.py", "launch/runctl.py",
            "launch/serve_gateway.py", "launch/worker_host.py",
            "launch/mesh.py", "launch/sharding.py", "launch/fault.py",
            "optim/layered_grads.py", "launch/axes.py",
            "launch/op_costs.py", "launch/roofline.py",
            "launch/dryrun.py", "examples/__init__.py",
            "examples/quickstart.py", "examples/runtime_deadline.py",
            "examples/serve_progressive.py", "examples/train_lm.py",
            "examples/fault_tolerance.py"} <= names
    for kernel in ("layered_matmul_wgmma", "flash_attention", "ssd_scan"):
        assert (PORT / "kernels" / "csrc" / f"{kernel}.cu").is_file()
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.runtime, repro_torch.kernels.ops\n"
        "import repro_torch.core.layered_matmul\n"
        "import repro_torch.runtime.transport.cuda_device\n"
        "import repro_torch.models, repro_torch.launch.serve\n"
        "import repro_torch.runtime.gateway, repro_torch.core.progressive\n"
        "import repro_torch.configs.registry\n"
        "import repro_torch.models.rglru, repro_torch.models.moe\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.checkpoint.store, repro_torch.data.pipeline\n"
        "import repro_torch.optim.optimizers, repro_torch.models.loss\n"
        "import repro_torch.launch.runctl, repro_torch.launch.serve_gateway\n"
        "import repro_torch.launch.worker_host\n"
        "import repro_torch.runtime.transport.process\n"
        "import repro_torch.runtime.transport.shm\n"
        "import repro_torch.runtime.transport.socket_host\n"
        "import repro_torch.runtime.trace_export\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
        "import repro_torch.launch.fault, repro_torch.optim.layered_grads\n"
        "import repro_torch.launch.axes, repro_torch.launch.op_costs\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "from repro_torch.examples import (fault_tolerance, quickstart,\n"
        "    runtime_deadline, serve_progressive, train_lm)\n"
        "from repro_torch.configs import registry\n"
        "[registry.get_config(a) for a in registry.ARCH_IDS]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
