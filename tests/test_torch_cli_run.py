"""``pio run`` and ``pio shell`` on the port (``tools/cli.py``) against the
JAX package's console, on the CPU.

``run`` imports a dotted ``module.callable`` and calls it with the
passthrough argv, or runs a bare module as ``__main__``; both consoles
give the same exit code and the same captured output for the same
targets (True, False, an int, None, a result object, ``SystemExit``
with a code or a message, a module main, the stdlib's ``platform``), and
both fail alike on a target that does not resolve, a package without a
``__main__``, and an import that fails inside a real module. ``shell``
binds ``storage``, ``store``, ``ctx`` and ``commands``; the port's
``ctx`` is a ``DeviceContext``, on the CPU here through ``--device
cpu`` (the card's check is in ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import io
import sys
import textwrap

import pytest

from predictionio_tpu.tools import cli as jax_cli
from predictionio_torch.tools import cli

from tests.test_torch_benchcmp import root_logging_restored  # noqa: F401
from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

TARGETS = textwrap.dedent('''\
    import sys

    def ok(argv):
        print("ok", argv)
        return True

    def fails(argv):
        print("fails", argv)
        return False

    def code(argv):
        return int(argv[0]) if argv else 7

    def nothing(argv):
        print("nothing")

    def result(argv):
        return {"rows": len(argv)}

    def exits(argv):
        sys.exit(int(argv[0]))

    def exits_with_message(argv):
        sys.exit("stopped: " + " ".join(argv))

    NOT_CALLABLE = 3
''')

MAIN = textwrap.dedent('''\
    import sys

    print("main", sys.argv[1:])
    if "--fail" in sys.argv:
        sys.exit(4)
''')

BROKEN = "import pio_run_no_such_dependency\n\n\ndef go(argv):\n    return 0\n"

CASES = [
    ["pio_run_targets.ok", "a", "--flag", "b"],
    ["pio_run_targets.fails"],
    ["pio_run_targets.code", "3"],
    ["pio_run_targets.code"],
    ["pio_run_targets.nothing"],
    ["pio_run_targets.result", "x", "y"],
    ["pio_run_targets.exits", "0"],
    ["pio_run_targets.exits", "5"],
    ["pio_run_targets.exits_with_message", "by", "test"],
    ["pio_run_main", "p", "q"],
    ["pio_run_main", "--fail"],
    ["pio_run_targets.NOT_CALLABLE"],
    ["pio_run_no_such_module.go"],
    ["pio_run_no_such_module"],
    ["pio_run_pkg"],
    ["platform"],
    ["platform", "--terse"],
]


@pytest.fixture()
def targets(tmp_path, monkeypatch):
    (tmp_path / "pio_run_targets.py").write_text(TARGETS)
    (tmp_path / "pio_run_main.py").write_text(MAIN)
    (tmp_path / "pio_run_broken.py").write_text(BROKEN)
    (tmp_path / "pio_run_pkg").mkdir()
    (tmp_path / "pio_run_pkg" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    yield
    for name in [m for m in sys.modules if m.startswith("pio_run_")]:
        del sys.modules[name]


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("case", CASES, ids=lambda c: " ".join(c))
def test_run_answers_like_jax(targets, capsys, case):
    jax_answer = _run(jax_cli.main, ["run"] + case, capsys)
    port_answer = _run(cli.main, ["run"] + case, capsys)
    assert port_answer == jax_answer


def test_run_exit_codes_and_argv(targets, capsys):
    """The exit-code mapping itself, and the argv a module main sees
    (restored afterwards)."""
    argv = list(sys.argv)
    assert [_run(cli.main, ["run"] + c, capsys)[0] for c in CASES[:11]] == [
        0, 1, 3, 7, 0, 0, 0, 5, 1, 0, 4]
    rc, out, _ = _run(cli.main, ["run", "pio_run_targets.ok", "a", "--flag",
                                 "b"], capsys)
    assert out == "ok ['a', '--flag', 'b']\n"
    rc, out, _ = _run(cli.main, ["run", "pio_run_main", "p"], capsys)
    assert out == "main ['p']\n" and sys.argv == argv
    rc, _, err = _run(cli.main, ["run", "pio_run_no_such_module"], capsys)
    assert rc == 1 and "cannot resolve 'pio_run_no_such_module'" in err


def test_run_reraises_an_import_error_inside_a_real_module(targets):
    for main in (jax_cli.main, cli.main):
        for target in ("pio_run_broken.go", "pio_run_broken"):
            with pytest.raises(ModuleNotFoundError,
                               match="pio_run_no_such_dependency"):
                main(["run", target])
            sys.modules.pop("pio_run_broken", None)


SHELL_SCRIPT = textwrap.dedent('''\
    print(sorted(k for k in ("storage", "store", "ctx", "commands") if k in globals()))
    print(type(storage).__name__, store.__name__.rsplit(".", 1)[-1], commands.__name__.rsplit(".", 1)[-1])
    print(sorted(a.name for a in storage.apps().get_all()))
''')


@pytest.fixture()
def shell_storage(monkeypatch):
    """Both packages' storage singletons over memory stores holding one
    app."""
    from predictionio_tpu.data import storage as jax_storage
    from predictionio_torch.data import storage as port_storage

    for module in (jax_storage, port_storage):
        store = module.Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE":
                                         "memory"})
        store.apps().insert("shellapp")
        monkeypatch.setattr(module, "get_storage", lambda s=store: s)
    monkeypatch.setattr(cli, "get_storage", port_storage.get_storage)
    monkeypatch.setattr(jax_cli, "get_storage", jax_storage.get_storage)


def _shell(main, argv, capsys, monkeypatch, script):
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def test_shell_binds_what_jaxs_binds(shell_storage, capsys, monkeypatch):
    jax_rc, jax_out, jax_err = _shell(jax_cli.main, ["shell"], capsys,
                                      monkeypatch, SHELL_SCRIPT)
    rc, out, err = _shell(cli.main, ["shell", "--device", "cpu"], capsys,
                          monkeypatch, SHELL_SCRIPT)
    assert rc == jax_rc == 0
    assert out == jax_out
    assert "['commands', 'ctx', 'storage', 'store']" in out
    assert "['shellapp']" in out
    assert "predictionio-torch shell" in err and "DeviceContext" in err


def test_shell_ctx_is_the_ports_device_context(shell_storage, capsys,
                                               monkeypatch):
    script = "print(type(ctx).__name__, ctx.device)\n"
    rc, out, _ = _shell(cli.main, ["shell", "--device", "cpu"], capsys,
                        monkeypatch, script)
    assert rc == 0 and "DeviceContext cpu" in out


def test_shell_without_a_card_refuses_the_default_device(shell_storage,
                                                         capsys,
                                                         monkeypatch):
    """With no ``--device`` the context is the card's; without one the
    console says so and exits 1, as every port command does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, _, err = _shell(cli.main, ["shell"], capsys, monkeypatch, "")
    assert rc == 1 and "--device cpu" in err
