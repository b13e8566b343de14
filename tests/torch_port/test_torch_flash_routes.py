"""The two routes of each kernel of ops/flash_cuda.py: the predicate that
picks one before any launch (each kernel takes wgmma at head_dim 64, 80,
96, 128 and 256 in 16 bits), the plain version for
CPU tensors, and the CUDA sources' notes and launchers. The kernels
themselves run only on the card (chip_smoke.py)."""

import re
import types

import pytest
import torch

from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import flash_cuda as fc

KERNELS = ("forward", "dkdv", "dq")
# The head_dims at which 16-bit inputs take each kernel's wgmma route, as
# its C launcher takes them; float32 and every other head_dim take mma.sync.
WGMMA_DIMS = {"forward": (64, 80, 96, 128, 256), "dkdv": (64, 80, 96, 128, 256),
              "dq": (64, 80, 96, 128, 256)}
CASES = [(dtype, D) for dtype in (torch.bfloat16, torch.float16) for D in (64, 80, 96, 128, 256)
         ] + [(torch.float32, 64), (torch.float32, 128), (torch.float32, 256),
              (torch.bfloat16, 32)]
ROUTES = {kernel: [(dtype, D, dtype != torch.float32 and D in WGMMA_DIMS[kernel])
                   for dtype, D in CASES] for kernel in KERNELS}
SM90_SOURCES = {"forward": "flash_fwd_sm90", "dkdv": "flash_bwd_dkdv_sm90",
                "dq": "flash_bwd_dq_sm90"}
REPLACED = {"flash_fwd": ["_fwd_kernel"], "flash_fwd_sm90": ["_fwd_kernel"],
            "flash_bwd": ["_bwd_dkdv_kernel", "_bwd_dq_kernel"],
            "flash_bwd_dkdv_sm90": ["_bwd_dkdv_kernel"], "flash_bwd_dq_sm90": ["_bwd_dq_kernel"]}
COUNTERS = (("flash_fwd", "launches"), ("flash_fwd", "wgmma_launches"),
            ("flash_fwd", "mma_launches"), ("flash_bwd", "dkdv_launches"),
            ("flash_bwd", "dkdv_wgmma_launches"), ("flash_bwd", "dkdv_mma_launches"),
            ("flash_bwd", "dq_launches"), ("flash_bwd", "dq_wgmma_launches"),
            ("flash_bwd", "dq_mma_launches"))


def counts():
    return {f"{fn}.{attr}": getattr(getattr(fc, fn), attr) for fn, attr in COUNTERS}


def qkv(dtype, D, device="cpu", B=1, S=48, H=4, G=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=gen).to(dtype)
    k = torch.randn((B, S, G, D), generator=gen).to(dtype)
    v = torch.randn((B, S, G, D), generator=gen).to(dtype)
    return tuple(t.to(device) for t in (q, k, v))


@pytest.mark.parametrize("kernel,dtype,D,wgmma",
                         [(kernel, *route) for kernel in KERNELS for route in ROUTES[kernel]])
def test_route_predicate(kernel, dtype, D, wgmma):
    assert fc._wgmma_route(kernel, dtype, D) is wgmma


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_wgmma_launcher_takes_the_head_dims_of_its_predicate(kernel):
    # The C launcher names every head_dim it was built for and refuses any
    # other; the predicate never sends it one it refuses.
    name = SM90_SOURCES[kernel]
    text = (_build.CSRC / f"{name}.cu").read_text()
    launcher = text[text.index(f'extern "C" int {name}('):]
    taken = sorted({int(d) for d in re.findall(r"D != (\d+)", launcher)})
    assert tuple(taken) == fc._WGMMA_HEAD_DIMS[kernel] == WGMMA_DIMS[kernel]


@pytest.mark.parametrize("dtype,D,wgmma", ROUTES["forward"])
def test_forward_dispatches_on_the_predicate_alone(monkeypatch, dtype, D, wgmma):
    # Meta tensors stand in for CUDA ones: the route is chosen from dtype and
    # head_dim before anything touches the card, and exactly one route runs.
    calls = []
    monkeypatch.setattr(fc, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(fc, "_fwd_wgmma", lambda *a: calls.append("wgmma"))
    monkeypatch.setattr(fc, "_fwd_mma", lambda *a: calls.append("mma.sync"))
    fc.flash_fwd(*qkv(dtype, D, device="meta"), causal=True)
    assert calls == ["wgmma" if wgmma else "mma.sync"]


@pytest.mark.parametrize("wgmma", [True, False])
def test_backward_dkdv_takes_its_route(wgmma):
    # dK/dV follows its own flag whatever dQ's says.
    calls = []
    launch = types.SimpleNamespace(dkdv_on_wgmma=wgmma, dq_on_wgmma=not wgmma,
                                   dkdv_wgmma=lambda: calls.append("wgmma"),
                                   dkdv_mma=lambda: calls.append("mma.sync"))
    fc._BackwardLaunch.dkdv(launch)
    assert calls == ["wgmma" if wgmma else "mma.sync"]


@pytest.mark.parametrize("wgmma", [True, False])
def test_backward_dq_takes_its_route(wgmma):
    calls = []
    launch = types.SimpleNamespace(dq_on_wgmma=wgmma, dkdv_on_wgmma=not wgmma,
                                   dq_wgmma=lambda: calls.append("wgmma"),
                                   dq_mma=lambda: calls.append("mma.sync"))
    fc._BackwardLaunch.dq(launch)
    assert calls == ["wgmma" if wgmma else "mma.sync"]


@pytest.mark.parametrize("dtype,D", CASES)
def test_backward_runs_dkdv_then_dq_on_one_route(monkeypatch, dtype, D):
    # Meta tensors stand in for CUDA ones, as in the forward's dispatch test:
    # a backward call launches dK/dV and then dQ, each on its own kernel's
    # route.
    calls = []
    monkeypatch.setattr(fc, "_check_cuda", lambda *a: None)
    for kernel in ("dkdv", "dq"):
        for route, label in (("wgmma", "wgmma"), ("mma", "mma.sync")):
            monkeypatch.setattr(fc._BackwardLaunch, f"{kernel}_{route}",
                                lambda self, kern=kernel, r=label: calls.append((kern, r)))
    q, k, v = qkv(dtype, D, device="meta")
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device="meta")
    dq, dk, dv = fc.flash_bwd(q, k, v, torch.empty_like(q), lse, torch.empty_like(q),
                              causal=True)
    routes = {kernel: "wgmma" if dtype != torch.float32 and D in WGMMA_DIMS[kernel] else "mma.sync"
              for kernel in ("dkdv", "dq")}
    assert calls == [("dkdv", routes["dkdv"]), ("dq", routes["dq"])]
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [80, 96, 256])
def test_backward_runs_both_kernels_on_wgmma_at_the_families_head_dims(monkeypatch, dtype, D):
    # Phi-2's, GPT-NeoX's and GPT-J's / Gemma2's head_dims: dK/dV on wgmma,
    # then dQ on wgmma, in that order; neither touches mma.sync.
    monkeypatch.setattr(fc, "_check_cuda", lambda *a: None)
    q, k, v = qkv(dtype, D, device="meta")
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device="meta")
    launch = fc._BackwardLaunch(q, k, v, torch.empty_like(q), lse, torch.empty_like(q), True,
                                None, None, None, None)
    assert (launch.dkdv_on_wgmma, launch.dq_on_wgmma) == (True, True)
    calls = []
    for kernel in ("dkdv", "dq"):
        for route, label in (("wgmma", "wgmma"), ("mma", "mma.sync")):
            monkeypatch.setattr(fc._BackwardLaunch, f"{kernel}_{route}",
                                lambda self, kern=kernel, r=label: calls.append(f"{kern} {r}"))
    monkeypatch.setattr(fc, "_BackwardLaunch", lambda *a, **kw: launch)
    fc.flash_bwd(q, k, v, torch.empty_like(q), lse, torch.empty_like(q), causal=True)
    assert calls == ["dkdv wgmma", "dq wgmma"]


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.float32, 64)])
def test_cpu_tensor_takes_the_plain_version_on_either_route(dtype, D):
    q, k, v = qkv(dtype, D)
    before = counts()
    out, lse = fc.flash_fwd(q, k, v, causal=True)
    ref, ref_lse = fc.flash_fwd_reference(q, k, v, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    grads = fc.flash_bwd(q, k, v, out, lse, d_out, causal=True)
    refs = fc.flash_bwd_reference(q, k, v, out, lse, d_out, causal=True)
    assert all(torch.equal(g, r) for g, r in zip(grads, refs))
    assert counts() == before


def test_a_failed_launch_raises_with_the_cuda_error():
    lib = types.SimpleNamespace(flash_fwd_sm90=lambda *a: 700,
                                flash_fwd_sm90_error_string=lambda code: b"an illegal memory access")
    with pytest.raises(RuntimeError, match="flash_fwd_sm90 kernel launch failed: an illegal"):
        fc._launch(lib, "flash_fwd_sm90", "flash_fwd_sm90", 0)


def test_every_source_has_its_launchers():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(fc._LAUNCHERS) == sources
    for name, launchers in fc._LAUNCHERS.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" const char* {name}_error_string(int code)' in text
        for fn, pointers in launchers.items():
            signature = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
            assert signature, f"{name}.cu defines no launcher {fn}"
            params = [p.strip() for p in signature.group(1).split(",")]
            assert len(params) == pointers + 12  # + dtype, 6 sizes, 2 floats, 2 options, stream
            assert all("*" in p for p in params[:pointers])


@pytest.mark.parametrize("name", sorted(REPLACED))
def test_source_notes_the_tpu_kernel_and_includes_no_pytorch_header(name):
    text = (_build.CSRC / f"{name}.cu").read_text()
    header = text.split("#include")[0]
    for kernel in REPLACED[name]:
        assert f"accelerate_tpu/ops/flash_pallas.py::{kernel}" in header or (
            kernel in header and "accelerate_tpu/ops/flash_pallas.py" in header)
    assert "What bounds it" in header or "What bounds them" in header
    assert not re.search(r'#include\s*[<"](torch|ATen|c10|pybind11)', text)


def test_shared_header_includes_no_pytorch_header():
    for path in _build.CSRC.glob("*.cuh"):
        assert not re.search(r'#include\s*[<"](torch|ATen|c10|pybind11)', path.read_text())
