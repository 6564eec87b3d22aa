"""The port's CLI surface against miraculix_tpu's, and its refusal to run on
the CPU unasked.

Both ``argparse`` parsers are captured without running a command (the
parser's ``parse_args`` raises with the parser), and their subcommands and,
per subcommand, option strings, destinations, defaults, choices, nargs,
types, actions and ``required`` must be the same; the one difference is
the port's top-level ``--device``.  On a host with no CUDA device the CLI
and every example exit nonzero, naming ``--device cpu``, unless given it.
"""
import argparse
import os
import subprocess
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import cli as ref_cli  # noqa: E402

from miraculix_tpu_torch import cli as pt_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def no_card():
    """These tests check a host without a CUDA device (decided here, in
    the test, so every worker collects the same tests)."""
    if torch.cuda.is_available():
        pytest.skip("checks the host without a CUDA device")


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser(main) -> argparse.ArgumentParser:
    def capture(self, args=None, namespace=None):
        raise _Captured(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Captured) as exc:
            main([])
    return exc.value.parser


def _actions(parser) -> dict:
    """Every action but help and the subcommand table, keyed by its option
    strings (or its destination, for a positional)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        key = tuple(a.option_strings) or a.dest
        out[key] = dict(dest=a.dest, default=a.default, choices=a.choices,
                        required=a.required, nargs=a.nargs,
                        type=getattr(a.type, "__name__", a.type),
                        action=type(a).__name__)
    return out


def _subcommands(parser) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    assert sub.required and sub.dest == "cmd"
    return dict(sub.choices)


def test_cli_surface_matches_reference():
    ref, port = _parser(ref_cli.main), _parser(pt_cli.main)
    top_ref, top_port = _actions(ref), _actions(port)
    assert top_port.pop(("--device",)) == dict(
        dest="device", default="cuda", choices=None, required=False,
        nargs=None, type=None, action="_StoreAction")
    assert top_port == top_ref
    subs_ref, subs_port = _subcommands(ref), _subcommands(port)
    assert sorted(subs_port) == sorted(subs_ref)
    assert len(subs_port) == 15
    for name in subs_ref:
        assert _actions(subs_port[name]) == _actions(subs_ref[name]), name
    assert sorted(pt_cli.COMMANDS) == sorted(subs_port)


@pytest.mark.parametrize("argv", [["info"], ["grm", "panel.bed"],
                                  ["--device", "cuda", "validate"],
                                  ["--device", "cuda:0", "info"]])
def test_cli_refuses_the_cpu_unasked(argv, capsys, no_card):
    with pytest.raises(SystemExit, match="--device cpu") as exc:
        pt_cli.main(argv)
    assert exc.value.code != 0


def test_cli_rejects_a_bad_device_name():
    with pytest.raises(SystemExit, match="--device 'gpu0'"):
        pt_cli.main(["--device", "gpu0", "info"])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    assert pt_cli.main(["--device", "cpu", "info"]) == 0
    assert "miraculix_tpu_torch" in capsys.readouterr().err


def test_cli_module_entry_refuses_the_cpu_unasked(no_card):
    """``python -m miraculix_tpu_torch.cli`` exits nonzero with the
    message on stderr."""
    proc = subprocess.run([sys.executable, "-m", "miraculix_tpu_torch.cli",
                           "info"], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
