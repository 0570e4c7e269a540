"""The port runs where JAX is not installed (GPU hosts need not have it).

1. Static: no module of fbanet_tpu_torch/ (its kernel-measurement tools in
   `tools/`, the convergence proof and `parallel/` included; nor
   chip_smoke.py) imports jax, flax, optax,
   jaxtyping, any module of the JAX package `fbanet_tpu` or its `scripts/`
   (the port keeps its own configuration, `fbanet_tpu_torch.config`, and its
   own copies of the tools).
2. Dynamic: a subprocess whose import system refuses those packages and all
   of `fbanet_tpu` runs a tiny CPU forward, registration (translation and
   homography ECC, optical flow), evaluation step and training step of the
   port, the windowed attention with the tools' ablation functions, the
   variant tool's K7 and K8 plain versions and the MFU fields, and the
   entry points that read a dataset: the synthetic tree writer,
   `train.main` for one epoch and `evaluate.main` on its checkpoint, with
   `--device cpu`.
"""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "jaxtyping")
ALLOWED_FROM_JAX_PACKAGE: set[str] = set()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    if top in BLOCKED or top == "scripts":
        return True
    return top == "fbanet_tpu" and name not in ALLOWED_FROM_JAX_PACKAGE


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "fbanet_tpu_torch").rglob("*.py"))
    assert len(files) >= 14
    tools = {f.name for f in files if f.parent.name == "tools"}
    assert {"measure_swin_rates.py", "measure_bwd.py",
            "measure_swin_variants.py", "profile_components.py",
            "flops_accounting.py", "convergence_proof.py"} <= tools, tools
    parallel = {f.name for f in files if f.parent.name == "parallel"}
    assert {"mesh.py", "dryrun.py"} <= parallel, parallel
    bad = [f"{f.relative_to(ROOT)}: {m}" for f in files + [ROOT / "chip_smoke.py"]
           for m in _imports(f) if _forbidden(m)]
    assert not bad, bad
    assert not any(m.startswith("fbanet_tpu")
                   for m in _imports(ROOT / "chip_smoke.py")
                   if not m.startswith("fbanet_tpu_torch"))


_SCRIPT = r"""
import sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED or top == "fbanet_tpu":
            raise ImportError("blocked in this test: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(2)
from fbanet_tpu_torch.evaluate import eval_step
from fbanet_tpu_torch.models import ModelConfig, create_model
from fbanet_tpu_torch.ops.registration import align_burst
from fbanet_tpu_torch.utils.weights import random_state_dict

cfg = ModelConfig(num_frames=2, img_size=16, embed_dim=8, window_size=4,
                  heads=(1, 2, 4, 8, 4, 4, 2, 2, 2), dtype="float32")
model = create_model(cfg, device="cpu")
model.load_state_dict(random_state_dict(model, 0))
burst = torch.rand(1, 2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
aligned, mats, _ = align_burst(burst, eps=1e-5)
aligned, mats, _ = align_burst(burst, motion="homography", levels=2,
                               iters_per_level=5)
assert torch.isfinite(mats).all() and torch.equal(aligned[:, 0], burst[:, 0])
from fbanet_tpu_torch.ops.registration import online_register
assert online_register(burst, "flow").shape == burst.shape
pred, psnr, ssim, _ = eval_step(model, burst, torch.rand(1, 64, 64, 3),
                                boundary_ignore=8)
assert pred.shape == (1, 64, 64, 3) and torch.isfinite(psnr).all()

from fbanet_tpu_torch.config import TrainConfig
from fbanet_tpu_torch.train import make_optimizer, make_train_step
tcfg = TrainConfig(lr_initial=1e-3)
step = make_train_step(model, make_optimizer(model.parameters(), tcfg), tcfg)
before = model.head.weight.detach().clone()
loss = step(burst, torch.rand(1, 64, 64, 3), torch.Generator().manual_seed(0),
            1e-3)
assert torch.isfinite(loss) and not torch.equal(before, model.head.weight)

from fbanet_tpu_torch.ops.attention import fused_window_attention
from fbanet_tpu_torch.tools.measure_bwd import _win_args, abl_backward
from fbanet_tpu_torch.tools.measure_swin_rates import _leff_args, abl_leff
x, g, *p = _win_args(32, 16, 2, batch=1, device="cpu")
xr = x.float().requires_grad_()
fused_window_attention(xr, *p[:7], torch.zeros(32), p[7], None, heads=2,
                       windows_per_image=4).sum().backward()
assert torch.isfinite(xr.grad).all()
assert len(abl_backward(32, 16, 2, core=False)(x, g, *p)) == 10
assert abl_leff(32, 16, dw=False)(*_leff_args(32, 16, batch=1,
                                              device="cpu")).shape[1] == 16
from fbanet_tpu_torch.tools import measure_swin_variants as mv
from fbanet_tpu_torch.tools.flops_accounting import mfu_fields
from fbanet_tpu_torch.tools.measure_swin_rates import _attn_args
assert mv.variant_attention(32, 16, 2, "lanepack")(
    *_attn_args(32, 16, 2, batch=1, device="cpu")).shape == (1, 16, 16, 32)
assert mv.variant_leff(32, 16, gelu_bf16=True)(
    *_leff_args(32, 16, batch=1, device="cpu")).shape == (1, 16, 16, 32)
assert mfu_fields(1, 2, 16, 8, 0.1, None, 1)["mfu_forward"] >= 0
import tempfile
from pathlib import Path
from fbanet_tpu_torch import evaluate as E
from fbanet_tpu_torch import train as T
from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr
with tempfile.TemporaryDirectory() as tmp:
    write_synthetic_realbsr(Path(tmp, "ds"), num_bursts=2, num_frames=2,
                            lr_size=16, level=1)
    common = ["--dataroot", str(Path(tmp, "ds")), "--train_ps", "16",
              "--embed_dim", "8", "--win_size", "4", "--burst_size", "2",
              "--dtype", "float32", "--device", "cpu"]
    res = T.main([*common, "--batch_size", "2", "--nepoch", "1",
                  "--save_dir", str(Path(tmp, "log")), "--train_workers", "1",
                  "--eval_workers", "1"])
    ckpt = Path(res["model_dir"], "model_best")
    ev = E.main([*common, "--weights", str(ckpt)])
    assert abs(ev["psnr"] - res["best_psnr"]) < 1e-4, (ev, res["best_psnr"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED
                or m.startswith("fbanet_tpu."))
print("LOADED", loaded)
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(blocked=set(BLOCKED))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
