"""``kernel_ab.py``'s case names and options, and the named kernel cases
of ``chip_smoke.py`` that it times (the timing itself needs a card)."""

import importlib.util
import inspect
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


kernel_ab = _load("kernel_ab")
chip_smoke = _load("chip_smoke")


@pytest.mark.parametrize("arg,want", [
    ("k4_q3", ("k4_q3", {})),
    ("a6_grouped:chunks=16", ("a6_grouped", {"chunks": 16})),
    ("a6_grouped:chunks=8,items=1000", ("a6_grouped", {"chunks": 8, "items": 1000})),
])
def test_parse_case(arg, want):
    assert kernel_ab.parse_case(arg) == want


@pytest.mark.parametrize("name", sorted(chip_smoke.KERNEL_CASES))
def test_kernel_case_takes_the_common_arguments(name):
    params = list(inspect.signature(chip_smoke.KERNEL_CASES[name]).parameters)
    assert params[:5] == ["torch", "np", "K", "shapes", "dev"]


def test_kernel_names_are_the_ports():
    names = kernel_ab.kernel_names(str(REPO))
    assert {"tiles", "fixup", "pack_contrib", "peers", "close_open", "pack_valid",
            "scan_assign", "merge_groups", "seg_sum_kernel"} <= names
    assert "elementwise_kernel_with_index" not in names


@pytest.mark.parametrize("key,want", [
    ("(anonymous namespace)::tiles(void const*, int, unsigned int const*)", "tiles"),
    ("void (anonymous namespace)::pack_valid<true>(unsigned char const*, long long, "
     "unsigned int*)", "pack_valid<true>"),
    # PyTorch's own kernels, one of them in an anonymous namespace too
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::arange_cuda_out>(int)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
    ("Memset (Device)", None),
])
def test_own_kernel_names(key, want):
    assert kernel_ab.own_kernel(key, kernel_ab.kernel_names(str(REPO))) == want


def test_unknown_case_is_refused(capsys):
    assert kernel_ab.main(["a", "b", "no_such_case"]) == 2
    assert "no_such_case" in capsys.readouterr().err
