"""The port's profiling tools against the JAX package's, on the same inputs.

- ``utils.kernel_trace`` (JAX ``utils/xplane.py``): one set of ops with
  whole-µs durations, written as an XSpace and as a Chrome trace, gives the
  same top ops (ms and counts) exactly; HLO and CUDA kernel names of the
  same kind (copy, convolution, collective, flash, Lion) fall in the same
  category under a fixed name map, and both ``category_report``s give the
  same ms a step and launches by category; each kernel is linked to the op
  that launched it; the busy time is the union across streams; a trace that
  asked for CUDA activity and holds no kernel raises.
- ``utils.roofline`` (JAX ``utils/hloaudit.py``): ``op_work`` of a
  ``torch.mm`` and of dense ``F.conv2d`` calls recorded by the CPU profiler
  equals ``parse_hlo(...).kernel_flops`` / ``kernel_bytes`` on HLO of the
  same shapes; ``tensor_bytes`` equals ``shape_bytes`` for every dtype the
  profiler names; ``attention_bound`` gives the bounds that ``PERF.md``
  prints for the ``kernels`` phase's rows.
- ``utils.hostcache`` (JAX ``utils/hostcache.py``): the purge leaves what
  the JAX one leaves on the same tree (``_`` read as ``-``), keeps another
  library whose name extends this one's, and removes a dead build's
  temporary file; the toolchain's version is part of ``library_path``.
"""

import json
import os
import re

import pytest
import torch
import torch.nn.functional as F

from stable_diffusion_training_tpu.utils import hloaudit, xplane
from stable_diffusion_training_tpu.utils import hostcache as jax_hostcache
from stable_diffusion_training_tpu.utils.tb_events import _int64, _ld
from stable_diffusion_training_tpu_torch.ops import cuda_build, flash_attention, lion_kernel
from stable_diffusion_training_tpu_torch.utils import hostcache, kernel_trace, roofline
from stable_diffusion_training_tpu_torch.utils.profiling import annotate_launch
from torch_threads import _one_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- traces written both ways -------------------------------------------------


def _xevent(meta_id, offset_ps, dur_ps):
    return _int64(1, meta_id) + _int64(2, offset_ps) + _int64(3, dur_ps)


def _xspace(ops):
    """An XSpace of one TPU plane whose "XLA Ops" line holds ``ops``:
    [(HLO name, [durations in µs])]."""
    line = _ld(2, b"XLA Ops")
    plane = _ld(2, b"/device:TPU:0")
    offset = 0
    for mid, (name, durs) in enumerate(ops, start=1):
        for us in durs:
            line += _ld(4, _xevent(mid, offset, us * 1_000_000))
            offset += us * 1_000_000
        meta = _int64(1, mid) + _ld(2, name.encode())
        plane += _ld(4, _int64(1, mid) + _ld(2, meta))
    plane += _ld(3, line)
    return _ld(1, plane)


def _chrome(ops, stream=7, pid=0):
    """Chrome trace events of ``ops`` ([(kernel name, [durations in µs])])
    as kernels on one stream, back to back."""
    events, ts = [], 1000
    for name, durs in ops:
        for us in durs:
            events.append(dict(ph="X", cat="kernel", name=name, pid=pid, tid=stream, ts=ts, dur=us, args={}))
            ts += us
    return events


# (HLO instruction, CUDA kernel of the same kind, their durations in µs)
KINDS = [
    ("%copy.104 = bf16[16,4096]{1,0:T(8,128)} copy(bf16[16,4096]{0,1} %reshape.3)",
     "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(at::TensorIteratorBase&)"
     "::{lambda(int)#1}>(int, at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&))",
     [700, 500, 900]),
    ("%convolution.7 = bf16[8,64,64,320]{3,2,1,0} convolution(bf16[8,64,64,320]{3,2,1,0} %p0, "
     "bf16[3,3,320,320]{3,2,1,0} %p1), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1"
     "_g1_execute_kernel__5x_cudnn",
     [4000, 3800]),
    ("%all-reduce.1 = f32[1024]{0} all-reduce(f32[1024]{0} %p2), replica_groups={}",
     "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     [1100]),
    ("%attn1.28 = (bf16[120,4096,40]{2,1,0}, bf16[120,4096,40]{2,1,0}) "
     "custom-call(bf16[120,4096,40]{2,1,0} %bitcast.1)",
     "void (anonymous namespace)::flash_fwd_tma_kernel<64, false>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "__nv_bfloat16*, float*, int, int, float)",
     [30000, 30100, 29900, 30200]),
    ("%custom-call.9 = (bf16[230400,128]{1,0}, s8[230400,128]{1,0}) custom-call(bf16[230400,128]{1,0} %p0)",
     "void (anonymous namespace)::lion_leaves_kernel<__nv_bfloat16, 16>((anonymous namespace)::LeafRecord "
     "const*, int const*, (anonymous namespace)::GradPtrs, __nv_bfloat16*, (anonymous namespace)::Coefs)",
     [290000, 31000]),
]
CATEGORY_OF_JAX = {
    "copy/relayout": "copy/relayout", "convolution": "convolution", "collective": "collective",
    "flash custom-call": "flash kernel", "lion custom-call": "lion kernel",
}


@pytest.fixture
def both_traces(tmp_path):
    xspace = tmp_path / "t.xplane.pb"
    xspace.write_bytes(_xspace([(hlo, durs) for hlo, _, durs in KINDS]))
    chrome = tmp_path / "t.json"
    chrome.write_text(json.dumps(dict(traceEvents=_chrome([(cuda, durs) for _, cuda, durs in KINDS]))))
    return str(xspace), str(chrome)


def test_top_ops_match_the_xplane_readers(both_traces, tmp_path):
    xspace, chrome = both_traces
    want = xplane.top_ops(xspace, k=4)
    got = kernel_trace.top_ops(chrome, k=4)
    names = {hlo: cuda for hlo, cuda, _ in KINDS}
    assert [(names[n], ms, c) for n, ms, c in want] == got
    assert got[0][1:] == (321.0, 2)  # the Lion kernel: 290,000 + 31,000 µs
    # gzipped, as the trainer keeps its traces
    import gzip

    with open(chrome, "rb") as src, gzip.open(str(tmp_path / "t.json.gz"), "wb") as dst:
        dst.write(src.read())
    assert kernel_trace.top_ops(str(tmp_path / "t.json.gz"), k=4) == got


@pytest.mark.parametrize("hlo,cuda", [(h, c) for h, c, _ in KINDS], ids=[k for k in CATEGORY_OF_JAX])
def test_categories_match_the_xplane_categories(hlo, cuda):
    assert kernel_trace.categorize(cuda) == CATEGORY_OF_JAX[xplane.categorize(hlo)]


def _report_rows(report, label):
    """{category: (ms a step, launches a step)} of one block of a report."""
    rows, inside = {}, False
    for line in report.splitlines():
        if line.startswith("["):
            inside = line.startswith(f"[{label}")
            continue
        m = re.match(r"^\s+([\d.]+) ms/step\s+[\d.]+%\s+x(\d+)\s+(\S.*)$", line)
        if inside and m:
            rows[m.group(3)] = (m.group(1), int(m.group(2)))
    return rows


def test_category_reports_agree(both_traces):
    xspace, chrome = both_traces
    want = _report_rows(xplane.category_report(xspace, steps=2, wall_ms=12.5), "serialized")
    report = kernel_trace.category_report(chrome, steps=2, wall_ms=12.5)
    got = _report_rows(report, "serialized")
    assert {CATEGORY_OF_JAX[c]: v for c, v in want.items()} == got
    assert len(got) == len(KINDS) and "wall 12.5 ms/step" in report
    assert "[collective streams (overlaps)] no events" in report


def test_collective_streams_are_reported_apart():
    events = _chrome([(KINDS[1][1], [40])], stream=7) + _chrome([(KINDS[2][1], [25, 25])], stream=13)
    table = kernel_trace.category_table(dict(traceEvents=events), steps=1)
    assert list(table["serialized"]["categories"]) == ["convolution"]
    assert table["collective_streams"]["categories"]["collective"]["launches"] == 2
    # the NCCL kernels overlap the convolution: busy is the union
    assert table["busy_ms"] == pytest.approx(0.050)


def test_csrc_kernels_are_categorized_by_their_names():
    """Every ``__global__`` kernel in ``csrc/`` is a ``flash kernel`` or a
    ``lion kernel`` by the name the trace gives it."""
    names = []
    for src in sorted(os.listdir(cuda_build.CSRC_DIR)):
        if src.endswith(".cu"):
            with open(os.path.join(cuda_build.CSRC_DIR, src)) as f:
                text = f.read()
            found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^;{]*?\)\s+)?(\w+)\s*\(", text)
            names += [(src, n) for n in found]
    assert len(names) >= 10
    for src, name in names:
        traced = f"void (anonymous namespace)::{name}<64, true>(float const*, int)"
        assert kernel_trace.family_of(traced) == name
        want = "lion kernel" if src.startswith("lion") else "flash kernel"
        assert kernel_trace.categorize(traced) == want, name


def test_family_of_strips_templates_parameters_and_namespaces():
    assert kernel_trace.family_of(KINDS[0][1]) == "at::native::elementwise_kernel"
    assert kernel_trace.family_of("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    assert kernel_trace.family_of("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT") == (
        "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT")
    assert kernel_trace.categorize("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT") == "gemm"
    assert kernel_trace.categorize("Memset (Device)") == "copy/relayout"
    assert kernel_trace.categorize(
        "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(long, float, "
        "float const*, float*, float*)") == "norm"


# --- linking kernels to ops; busy time ---------------------------------------


def _op(name, ts, dur, ext, cat="cpu_op", tid=1, **args):
    return dict(ph="X", cat=cat, name=name, pid=100, tid=tid, ts=ts, dur=dur, args={"External id": ext, **args})


def _launch(ts, corr, ext, tid=1):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=100, tid=tid, ts=ts, dur=3,
                args={"correlation": corr, "External id": ext})


def _kernel(name, ts, dur, corr=None, ext=None, stream=7):
    args = {k: v for k, v in (("correlation", corr), ("External id", ext)) if v is not None}
    return dict(ph="X", cat="kernel", name=name, pid=0, tid=stream, ts=ts, dur=dur, args=args)


FLASH_KEY = (2, 64, 64, 40, "bfloat16", "tma_narrow")
FLASH = roofline.launch_name("flash_attention_fwd", FLASH_KEY,
                             flash_attention.launch_work("flash_attention_fwd", FLASH_KEY))
MM_ARGS = {"Input Dims": [[32, 64], [64, 48]], "Input type": ["c10::BFloat16", "c10::BFloat16"],
           "Concrete Inputs": ["", ""]}


def _linked_trace():
    events = [
        _op("aten::linear", 0, 120, 1),
        _op("aten::mm", 5, 100, 2, **MM_ARGS),
        _launch(10, corr=50, ext=2),
        _op("FlashAttention.forward", 200, 150, 3),
        _op(FLASH, 210, 100, 4, cat="user_annotation"),
        _launch(250, corr=51, ext=3),  # the kernel's External id names the aten op, not the annotation
        _kernel("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT", 400, 20, corr=50, ext=2),
        _kernel("void (anonymous namespace)::flash_fwd_tma_kernel<64, false>(CUtensorMap)", 430, 40,
                corr=51, ext=3),
        _kernel("void at::native::vectorized_elementwise_kernel<4>(int)", 480, 5, ext=2),  # no launch traced
        _kernel("void at::native::reduce_kernel<512, 1>(int)", 490, 5),  # linked to nothing
    ]
    return dict(traceEvents=events)


def test_kernel_ops_finds_the_innermost_launching_op():
    linked = [(e["name"][:12], op and op["name"]) for e, op in kernel_trace.kernel_ops(_linked_trace())]
    assert linked == [
        ("nvjet_hsh_12", "aten::mm"), ("void (anonym", FLASH),
        ("void at::nat", "aten::mm"), ("void at::nat", None),
    ]


def test_parse_ops_counts_work_and_bounds():
    index = roofline.parse_ops(_linked_trace())
    by_name = {op["name"]: op_id for op_id, op in index.ops.items()}
    mm, flash = by_name["aten::mm"], by_name[FLASH]
    assert index.kernel_flops(mm) == 2.0 * 32 * 48 * 64
    assert index.kernel_bytes(mm) == 2 * (32 * 64 + 64 * 48 + 32 * 48)
    assert index.device_ms(mm) == pytest.approx(0.025)  # the nvjet kernel and the unlaunched one
    ms, by, flops = roofline.attention_bound(2, 64, 64, 40, "bfloat16", reads_q=1, writes_q=1)
    assert index.bound_ms(flash) == ms and index.kernel_flops(flash) == flops
    assert index.share(flash) == pytest.approx(ms / 0.040)
    roof = kernel_trace.category_roofline(index, steps=1)
    assert roof["flash kernel"]["bound_ms"] == ms
    assert set(roof) == {"flash kernel", "gemm"}


def test_ops_traced_without_shapes_count_no_work():
    """A trace recorded without ``record_shapes`` (the trainer's
    ``profile_trace_dir``) names its ops bare: no work is counted for them,
    and the category table still reads."""
    trace = _linked_trace()
    for e in trace["traceEvents"]:
        if e["name"] == "aten::mm":
            e["args"] = {"External id": e["args"]["External id"]}
    index = roofline.parse_ops(trace)
    assert [index.ops[i]["name"] for i in index.work] == [FLASH]
    assert set(kernel_trace.category_roofline(index, steps=1)) == {"flash kernel"}
    assert "[roofline]" in kernel_trace.category_report(trace, steps=1)
    (conv,) = _recorded(lambda: F.conv2d(torch.ones(1, 2, 4, 4), torch.ones(2, 2, 3, 3)), "aten::convolution")
    assert roofline.op_work(dict(conv, args={})) is None


def test_device_busy_is_the_union_across_streams():
    events = [
        _kernel("a", 0, 10, stream=7), _kernel("b", 5, 10, stream=8),  # overlap: 0-15
        _kernel("c", 20, 5, stream=7), _kernel("d", 21, 2, stream=8),  # inside c: 20-25
        _kernel("e", 30, 10, stream=9),
        dict(ph="X", cat="cpu_op", name="aten::mm", pid=1, tid=1, ts=-10, dur=60, args={}),
    ]
    trace = dict(traceEvents=events)
    assert kernel_trace.device_busy(trace) == 30
    assert kernel_trace.idle_share(trace) == pytest.approx(1 - 30 / 60)


def test_a_cuda_trace_without_kernels_raises(tmp_path):
    trace = dict(traceEvents=[_op("aten::mm", 0, 10, 1), _launch(2, corr=5, ext=1)])
    for reader in (kernel_trace.op_durations, kernel_trace.device_busy, kernel_trace.kernel_ops):
        with pytest.raises(ValueError, match="no kernel"):
            reader(trace)
    with pytest.raises(ValueError, match="no kernel"):
        kernel_trace.category_report(dict(trace, deviceProperties=[{"name": "H100"}], traceEvents=[]), steps=1)
    # a trace that never asked for the card has no device events and is no error
    assert kernel_trace.op_durations(dict(traceEvents=[_op("aten::mm", 0, 10, 1)])) == {}


# --- flops and bytes against the HLO audit ------------------------------------


def _recorded(fn, name):
    """The ``name`` cpu_op events of ``fn`` under the CPU profiler with
    shapes recorded, from its exported Chrome trace."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = kernel_trace.load_trace(path)["traceEvents"]
    return [e for e in events if e.get("cat") == "cpu_op" and e["name"] == name]


HLO_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mm_work_matches_the_hlo_audit(dtype):
    m, k, n = 24, 40, 56
    a, b = torch.ones(m, k, dtype=dtype), torch.ones(k, n, dtype=dtype)
    (event,) = _recorded(lambda: torch.mm(a, b), "aten::mm")
    t = HLO_TYPES[dtype]
    hlo = f"""\
HloModule m

%fused_dot (p0: {t}[{m},{k}], p1: {t}[{k},{n}]) -> {t}[{m},{n}] {{
  %p0 = {t}[{m},{k}]{{1,0}} parameter(0)
  %p1 = {t}[{k},{n}]{{1,0}} parameter(1)
  ROOT %dot = {t}[{m},{n}]{{1,0}} dot(%p0, %p1), lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}
}}

ENTRY %main (a: {t}[{m},{k}], b: {t}[{k},{n}]) -> {t}[{m},{n}] {{
  %a = {t}[{m},{k}]{{1,0}} parameter(0)
  %b = {t}[{k},{n}]{{1,0}} parameter(1)
  ROOT %fusion.1 = {t}[{m},{n}]{{1,0}} fusion(%a, %b), kind=kOutput, calls=%fused_dot
}}
"""
    idx = hloaudit.parse_hlo(hlo)
    assert roofline.op_work(event) == (idx.kernel_flops("fusion.1"), idx.kernel_bytes("fusion.1"))


@pytest.mark.parametrize(
    "stride,padding,bias", [(1, 1, False), (2, 1, False), (2, 0, True), (1, 2, True)],
    ids=["s1-p1", "s2-p1", "s2-p0-bias", "s1-p2-bias"],
)
def test_dense_conv_work_matches_the_hlo_audit(stride, padding, bias):
    """A dense convolution (JAX's count overcounts grouped ones): flops and
    bytes of ``aten::convolution`` against the HLO audit of the same
    shapes, laid out NHWC/HWIO as XLA has them."""
    nb, cin, cout, h, w, kh = 2, 8, 16, 10, 9, 3
    x, wt = torch.ones(nb, cin, h, w), torch.ones(cout, cin, kh, kh)
    b = torch.ones(cout) if bias else None
    (event,) = _recorded(lambda: F.conv2d(x, wt, b, stride=stride, padding=padding), "aten::convolution")
    oh, ow = ((s + 2 * padding - kh) // stride + 1 for s in (h, w))
    bias_param = f", p2: f32[{cout}]" if bias else ""
    bias_arg = f", %c" if bias else ""
    bias_line = f"  %c = f32[{cout}]{{0}} parameter(2)\n" if bias else ""
    hlo = f"""\
HloModule m

%fused_conv (p0: f32[{nb},{h},{w},{cin}], p1: f32[{kh},{kh},{cin},{cout}]{bias_param}) -> f32[{nb},{oh},{ow},{cout}] {{
  %p0 = f32[{nb},{h},{w},{cin}]{{3,2,1,0}} parameter(0)
  %p1 = f32[{kh},{kh},{cin},{cout}]{{3,2,1,0}} parameter(1)
  ROOT %conv = f32[{nb},{oh},{ow},{cout}]{{3,2,1,0}} convolution(%p0, %p1), window={{size={kh}x{kh} stride={stride}x{stride} pad={padding}_{padding}x{padding}_{padding}}}, dim_labels=b01f_01io->b01f
}}

ENTRY %main (a: f32[{nb},{h},{w},{cin}], b: f32[{kh},{kh},{cin},{cout}]{bias_param}) -> f32[{nb},{oh},{ow},{cout}] {{
  %a = f32[{nb},{h},{w},{cin}]{{3,2,1,0}} parameter(0)
  %b = f32[{kh},{kh},{cin},{cout}]{{3,2,1,0}} parameter(1)
{bias_line}  ROOT %fusion.1 = f32[{nb},{oh},{ow},{cout}]{{3,2,1,0}} fusion(%a, %b{bias_arg}), kind=kOutput, calls=%fused_conv
}}
"""
    idx = hloaudit.parse_hlo(hlo)
    assert roofline.op_work(event) == (idx.kernel_flops("fusion.1"), idx.kernel_bytes("fusion.1"))


def test_conv_backward_work_follows_the_output_mask():
    x = torch.ones(2, 8, 10, 9, requires_grad=True)
    wt = torch.ones(16, 8, 3, 3, requires_grad=True)
    y = F.conv2d(x, wt, stride=2, padding=1)
    (event,) = _recorded(lambda: y.backward(torch.ones_like(y)), "aten::convolution_backward")
    per = 2.0 * y.numel() * 8 * 3 * 3
    flops, nbytes = roofline.op_work(event)
    assert flops == 2 * per  # grad input and grad weight; the conv had no bias
    assert nbytes == 4 * (y.numel() + 2 * x.numel() + 2 * wt.numel())


TENSOR_TYPES = {  # torch dtype -> the HLO type of the same width
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16", torch.int8: "s8", torch.uint8: "u8",
    torch.int64: "s64", torch.int32: "s32", torch.bool: "pred", torch.float64: "f64",
}


def test_tensor_bytes_match_shape_bytes_for_every_traced_type():
    dims = [3, 5, 7]
    seen = {}
    for dtype, hlo in TENSOR_TYPES.items():
        t = torch.zeros(dims, dtype=dtype)
        (event,) = _recorded(lambda: t.clone(), "aten::clone")
        seen[event["args"]["Input type"][0]] = dtype
        got = roofline.tensor_bytes(event["args"]["Input Dims"][0], event["args"]["Input type"][0])
        assert got == hloaudit.shape_bytes(f"{hlo}[{','.join(map(str, dims))}]"), dtype
    assert set(seen) == set(roofline.TRACE_TYPES)
    assert roofline.tensor_bytes([], "Scalar") == 0 and roofline.tensor_bytes([], "float") == 4


def test_launch_annotations_name_the_wrapper_and_shape():
    """Under a profiler a launch is named by its wrapper, shape and the
    wrapper's own count of its work, and the roofline reads the work back
    exactly without knowing the wrapper; without one nothing is recorded."""
    key = (2, 64, 64, 40, torch.bfloat16, "tma_narrow")
    from torch.profiler import ProfilerActivity, profile

    work = flash_attention.launch_work("flash_attention_fwd", FLASH_KEY)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate_launch("flash_attention_fwd", key, lambda: work):
            torch.zeros(1)
    names = [e.name for e in prof.events()]
    assert FLASH in names
    assert roofline.parse_launch(FLASH) == ("flash_attention_fwd[2,64,64,40,bfloat16,tma_narrow]", work)
    assert roofline.op_cost(dict(name=FLASH)) == work
    assert roofline.parse_launch("aten::mm") is None
    assert roofline.parse_launch("flash_attention_fwd[2,64,64,40,bfloat16,tma_narrow]") is None
    assert not torch.autograd._profiler_enabled()
    assert annotate_launch("flash_attention_fwd", key, lambda: work).__class__.__name__ == "nullcontext"
    # every flash wrapper counts its work
    for entry in flash_attention._WRAPPERS:
        assert flash_attention.launch_work(entry, FLASH_KEY).flops > 0
    for entry, key in (("lion8bit_update_leaves_", (3, 65536, 16, "bfloat16")),
                       ("lion8bit_update_", (4096, 16, torch.bfloat16)),
                       ("lion8bit_update_multi_", (3, 4096, 16, "bfloat16")),
                       ("fused_lion8bit_update", ("narrow", 4096, 16, "bfloat16"))):
        assert hasattr(lion_kernel, entry)
        work = lion_kernel.launch_work(entry, key)
        assert work == roofline.Work(0.0, 0.0, roofline.lion_bytes(65536, 4096, 2), "bfloat16")
        assert roofline.op_work(dict(name=roofline.launch_name(entry, key, work))) == (0.0, work.bytes)


# the kernels phase's rows in PERF.md's table of TPU kernels, with the
# arguments chip_smoke.py computes each with: (shape, dtype, arguments, the
# wrapper whose launches they bound, Bound ms as printed)
PINNED_BOUNDS = [
    ((64, 4096, 40), "float32", dict(products=5, writes_q=1, writes_k=2, stats=2, f32_q=2 * 32),
     "flash_attention_bwd_f32_fused", "6.4104"),
    ((64, 4096, 40), "bfloat16", dict(reads_q=1, writes_q=1), "flash_attention_fwd", "0.2568"),
    ((8, 4096, 512), "bfloat16", dict(reads_q=1, writes_q=1), "flash_attention_fwd", "0.2779"),
    ((40, 4096, 64), "bfloat16", dict(products=5, writes_q=1, writes_k=2, stats=2, f32_q=2),
     "flash_attention_bwd_fused", "0.4343"),
]


@pytest.mark.parametrize("shape,dtype,args,entry,printed", PINNED_BOUNDS,
                         ids=["bwd-f32-64x4096x40", "k1-bf16-narrow", "k1-bf16-wide", "bwd-bf16-40x4096x64"])
def test_attention_bound_pins_the_kernel_table(shape, dtype, args, entry, printed):
    bh, s, d = shape
    ms, by, _ = roofline.attention_bound(bh, s, s, d, dtype, **args)
    assert f"{ms:.4f}" == printed and by == "operations"
    # the wrapper's own count of a launch at this shape gives the same bound
    assert flash_attention.launch_work(entry, (bh, s, s, d, dtype)).bound()[0] == ms
    assert roofline.lion_bytes(10, 2, 2) == 10 * 6 + 16


# --- the build cache -------------------------------------------------------------


def _tree(base, sep, key):
    """Library directories of two names under ``base``, with ``sep``
    between name and key: this key, two stale ones, a longer name, a
    short key, another library."""
    names = []
    for lib in ("flashfwd", "lionupdate"):
        names += [f"{lib}{sep}{key}", f"{lib}{sep}0123456789abcdef", f"{lib}{sep}fedcba9876543210",
                  f"{lib}x{sep}0123456789abcdef"]
    names += [f"probe{sep}0123456789abcdef", "probe"]
    for n in names:
        os.makedirs(os.path.join(base, n, "inner"))
    return names


def test_purge_leaves_what_the_jax_purge_leaves(tmp_path, monkeypatch):
    key = "aaaabbbbccccdddd"
    monkeypatch.setattr(jax_hostcache, "host_cache_fingerprint", lambda: key)
    jax_base, port_base = str(tmp_path / "jax"), str(tmp_path / "port")
    _tree(jax_base, "_", key)
    _tree(port_base, "-", key)
    for lib in ("flashfwd", "lionupdate"):
        want = jax_hostcache.prepare_cache_dir(jax_base, lib)
        got = hostcache.prepare_cache_dir(port_base, lib, key)
        assert os.path.basename(got) == os.path.basename(want).replace("_", "-")
    left = sorted(n.replace("_", "-") for n in os.listdir(jax_base))
    assert sorted(os.listdir(port_base)) == left
    assert "flashfwd-0123456789abcdef" not in left and "flashfwdx-0123456789abcdef" in left


def test_purge_keeps_a_longer_name_and_live_builds(tmp_path):
    base = str(tmp_path)
    for n in ("flash_attention-1111111111111111", "flash_attention_fwd-2222222222222222",
              "flash_attention-333333333333333", "flash_attention-4444444444444444"):
        os.makedirs(os.path.join(base, n))
    keep = os.path.join(base, "flash_attention-4444444444444444")
    dead = os.path.join(keep, "libflash_attention.so.999999999.tmp")
    live = os.path.join(keep, f"libflash_attention.so.{os.getpid()}.tmp")
    for p in (dead, live):
        open(p, "w").close()
    assert hostcache.prepare_cache_dir(base, "flash_attention", "4444444444444444") == keep
    assert sorted(os.listdir(base)) == [
        "flash_attention-333333333333333", "flash_attention-4444444444444444",
        "flash_attention_fwd-2222222222222222",
    ]
    assert os.listdir(keep) == [os.path.basename(live)]


def test_the_toolchain_is_part_of_the_library_key(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\ncat "$(dirname "$0")/version"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    sources = flash_attention.LIBRARIES["flash_attention_fwd"]
    paths = []
    try:
        for version in ("Cuda compilation tools, release 12.8, V12.8.93",
                        "Cuda compilation tools, release 12.9, V12.9.41",
                        "Cuda compilation tools, release 12.8, V12.8.93"):
            (bin_dir / "version").write_text(version + "\n")
            hostcache.toolchain_fingerprint.cache_clear()
            paths.append(cuda_build.library_path("flash_attention_fwd", sources))
            parts = hostcache.toolchain_parts(str(nvcc), cuda_build.NVCC_FLAGS)
            assert parts["nvcc"] == version and parts["flags"] == " ".join(cuda_build.NVCC_FLAGS)
    finally:
        hostcache.toolchain_fingerprint.cache_clear()
    assert paths[0] != paths[1] and paths[0] == paths[2]
    assert re.fullmatch(r"flash_attention_fwd-[0-9a-f]{16}", os.path.basename(os.path.dirname(paths[0])))
    assert hostcache.host_compiler(["-ccbin", "g++-12"]) == "g++-12"
    assert hostcache.host_compiler(["--compiler-bindir=clang++"]) == "clang++"
