"""`python -m lsm_tpu_torch` takes main.py's flags and builds the config
lsm_tpu's CLI builds from them."""

import argparse

import pytest

from lsm_tpu import config as jcfg
from lsm_tpu.cli import common as jcli

from lsm_tpu_torch import __main__ as tcli
from lsm_tpu_torch import config as tcfg

# Flags both parsers take, and the port's own (--device, --hard), which
# lsm_tpu's parser does not know.
ARGVS = [
    [],
    ["--leak-variance-divisor", "4", "--redundancy-factor", "2", "--vocab", "v35",
     "--commands", "yes,no"],
    ["--n-filters", "64", "--num-neurons", "512", "--num-output-neurons", "128", "--sparse",
     "--multiplier", "1.2", "--feature-set", "all", "--vocab", "v35",
     "--samples-per-class", "30", "--batch-size", "64", "--leak-variance-divisor", "2.5"],
]
PORT_ONLY = ["--device", "cpu", "--hard"]


def _reference_args(argv):
    p = argparse.ArgumentParser()
    jcli.add_frontend_flags(p)
    jcli.add_extract_flags(p)
    jcli.add_extension_flags(p)
    return p.parse_args(argv)


def _assert_fields_equal(port, ref, path):
    import dataclasses

    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b, f"{path}.{f.name}")
        else:
            assert a == b and type(a) is type(b), f"{path}.{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("argv", ARGVS)
def test_same_argv_builds_the_same_config(argv):
    port = tcli.build_config(tcli.parse_args(argv + PORT_ONLY))
    ref = jcli.build_config(_reference_args(argv))
    _assert_fields_equal(port, ref, "PipelineConfig")


@pytest.mark.parametrize("argv,expect", [
    ([], jcfg.COMMANDS_12),
    (["--vocab", "v35"], jcfg.COMMANDS_35),
    (["--vocab", "v35", "--commands", " yes, no ,up,down"], ("yes", "no", "up", "down")),
])
def test_resolve_commands_agrees_with_reference(argv, expect):
    port = tcli.resolve_commands(tcli.parse_args(argv))
    assert port == jcli.resolve_commands(_reference_args(argv)) == expect
    assert tcfg.COMMANDS_35 == jcfg.COMMANDS_35


@pytest.mark.parametrize("raw", ["yes", "yes,no,yes"])
def test_resolve_commands_refuses_what_the_reference_refuses(raw):
    for resolve, args in ((tcli.resolve_commands, tcli.parse_args(["--commands", raw])),
                          (jcli.resolve_commands, _reference_args(["--commands", raw]))):
        with pytest.raises(SystemExit):
            resolve(args)


def test_cli_runs_with_the_new_flags(capsys):
    """The four flags end to end on the CPU: one class per --commands word,
    redundant channels, heterogeneous leak."""
    tcli.main(["--synthetic", "--samples-per-class", "20", "--leak-variance-divisor", "4",
               "--redundancy-factor", "2", "--commands", "yes,no,up,down", "--n-filters", "16",
               "--num-neurons", "200", "--num-output-neurons", "100", "--device", "cpu",
               "--skip-artifacts"])
    out = capsys.readouterr().out
    assert "Shape: (80, 32, 400)" in out and "--- Pipeline Finished ---" in out
    report = out.split("Classification Report:")[1]
    assert [w for w in ("yes", "no", "up", "down", "visual") if f" {w} " in report] == \
        ["yes", "no", "up", "down"]
