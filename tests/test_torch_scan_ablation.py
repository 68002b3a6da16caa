"""The scan ablation script (bench/scan_ablation.py) off the card: every
variant names switches that the scan cores honour, a variant is the
library built with those switches defined, and the table prints every
case. The timings themselves need the GPU (the script refuses to run
without one)."""

import re

import pytest

torch = pytest.importorskip("torch")

from vector_store_tpu_torch.bench import scan_ablation  # noqa: E402
from vector_store_tpu_torch.ops import kernels  # noqa: E402

CORES = (kernels.CSRC_DIR / "hopper_scan.cuh").read_text()
SWITCHES = sorted(set(re.findall(r"#ifdef (VST_ABLATE_\w+)", CORES)))


@pytest.mark.parametrize("name", list(scan_ablation.VARIANTS))
def test_variant_names_switches_of_the_cores(name):
    switches = scan_ablation.VARIANTS[name]
    assert set(switches) <= set(SWITCHES)
    assert bool(switches) == (name != "as built")


@pytest.mark.parametrize("switch", SWITCHES)
def test_switch_has_a_variant_and_guards_a_macro_the_cores_use(switch):
    assert any(switch in switches for switches in scan_ablation.VARIANTS.values())
    macro = re.search(rf"#ifdef {switch}\b.*\n#define (VST_\w+)\(", CORES).group(1)
    assert len(re.findall(rf"#define {macro}\(", CORES)) == 2  # cut out, and as built
    assert len(re.findall(rf"(?<!#define ){macro}\(", CORES)) >= 1  # used by a core


def test_the_cores_have_three_switches():
    assert SWITCHES == ["VST_ABLATE_FOLD", "VST_ABLATE_PRODUCT", "VST_ABLATE_QUERY_READS"]


def test_build_variant_defines_the_variants_switches(monkeypatch):
    built = []
    monkeypatch.setattr(kernels, "load", lambda flags=(): (built.append(flags) or "lib", None, ""))
    assert scan_ablation.build_variant("no product, no fold") == "lib"
    assert scan_ablation.build_variant("as built") == "lib"
    assert built == [("-DVST_ABLATE_PRODUCT", "-DVST_ABLATE_FOLD"), ()]


def test_extra_flags_reach_nvcc_and_key_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    seen = []

    def fake_build(sources, so, flags):
        seen.append((so.name, flags))
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(kernels, "_build", fake_build)
    for flags in ((), ("-DVST_ABLATE_FOLD",)):
        with pytest.raises(RuntimeError, match="no compiler here"):
            kernels.load(flags)
    (plain, f0), (cut, f1) = seen
    assert (f0, f1) == ((), ("-DVST_ABLATE_FOLD",))
    assert plain != cut  # a variant never stands in for the library


def test_table_has_a_row_per_variant_and_a_column_per_case():
    result = {"as built": {"fused F32": 8.5, "grouped I8": 1.25}, "no fold": {"fused F32": 8.0, "grouped I8": 1.2}}
    lines = scan_ablation.table(result)
    assert len(lines) == 3 and "fused F32" in lines[0] and "grouped I8" in lines[0]
    assert lines[1].startswith("as built") and "8.500 ms" in lines[1] and "1.250 ms" in lines[1]


def test_main_needs_a_gpu_and_known_variants(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert scan_ablation.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        scan_ablation.main(["no such variant"])
