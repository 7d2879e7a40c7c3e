"""The port's observability commands against the JAX console's.

A port engine server and a JAX engine server (the constant engine, on
the CPU) answer a few traced queries; then each of ``metrics``,
``flight``, ``trace``, ``profile``, ``prof``, ``journal``,
``anomalies``, ``data``, ``mem`` and ``top`` runs in process through
``predictionio_torch.tools.cli.main`` against the port server and
through ``predictionio_tpu.tools.cli.main`` against the JAX server.
Exit codes must be equal, and so must the keys of what ``--json``
prints; the commands that read this process's own state without
``--url`` exit as the JAX ones do.
"""

import json
import logging
import urllib.request

import pytest

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.tools import cli as jax_cli
from predictionio_torch.data.storage import Storage
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.tools import cli

from tests.test_health import train_const as jax_train_const
from tests.torch_operator_fixtures import (port_operator_state,  # noqa: F401
                                           train_const)

#: trace ids no other test of the port sends (flight records and spans
#: are process-wide)
TRACE, UNSEEN = "1f" * 16, "2e" * 16


@pytest.fixture(autouse=True)
def root_logging():
    """``cli.main`` installs its console handler on the root logger,
    bound to this test's captured stderr: take it off afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for handler in list(root.handlers):
        if handler not in handlers:
            root.removeHandler(handler)
    root.setLevel(level)


def _query(port, trace_id=None):
    headers = {"Content-Type": "application/json"}
    if trace_id:
        headers["X-PIO-Trace-Id"] = trace_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", method="POST",
        data=json.dumps({"mult": 3}).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def servers():
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    engine, _ = train_const(storage)
    port = EngineServer(engine, "const", host="127.0.0.1", port=0,
                        storage=storage, device="cpu",
                        micro_batch=False).start()
    jax_storage = JaxStorage.from_env({"PIO_STORAGE_SOURCES_M_TYPE":
                                       "memory"})
    jax_engine, _ = jax_train_const(jax_storage)
    jax = JaxServer(jax_engine, "const", host="127.0.0.1", port=0,
                    storage=jax_storage, micro_batch=False).start()
    try:
        for server in (port, jax):
            for k in range(6):
                _query(server.port, TRACE if k == 0 else None)
        yield {"port": f"http://127.0.0.1:{port.port}",
               "jax": f"http://127.0.0.1:{jax.port}"}
    finally:
        port.stop()
        jax.stop()


def _run(main, argv, capsys):
    capsys.readouterr()
    code = main(argv)
    return code, capsys.readouterr().out


def _json_keys(out):
    doc = json.loads(out)
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


#: (argv with {url} for the server's base URL, whether stdout is JSON)
CASES = [
    (["metrics", "--url", "{url}"], False),
    (["flight", "--url", "{url}", "-n", "3"], True),
    (["flight", "--url", "{url}", "--slow"], True),
    (["trace", TRACE, "--url", "{url}", "--json"], True),
    (["trace", TRACE, "--url", "{url}"], False),
    (["trace", UNSEEN, "--url", "{url}", "--json"], True),
    (["profile", "--url", "{url}", "--seconds", "0.05"], False),
    (["prof", "--url", "{url}", "--json"], True),
    (["prof", "--url", "{url}", "--endpoint", "/queries.json"], False),
    (["prof", "--url", "{url}", "--collapsed"], False),
    (["prof", "--url", "{url}", "--fleet"], False),
    (["journal", "--url", "{url}", "--json", "-n", "5"], True),
    (["journal", "--url", "{url}"], False),
    (["anomalies", "--url", "{url}", "--json"], True),
    (["anomalies", "--url", "{url}"], False),
    (["anomalies", "--url", "{url}", "--fleet"], False),
    (["data", "--url", "{url}", "--json"], True),
    (["data", "--url", "{url}"], False),
    (["mem", "--url", "{url}", "--json"], True),
    (["mem", "--url", "{url}"], False),
    (["top", "--url", "{url}", "--once", "--json"], True),
    (["top", "--url", "{url}", "--once"], False),
    (["top", "--url", "{url}", "--json"], False),
    (["top", "--fleet", "--once"], False),
]


@pytest.mark.parametrize("argv,is_json", CASES,
                         ids=[" ".join(c[0][:3]) for c in CASES])
def test_each_command_exits_and_answers_like_jax(servers, capsys, argv,
                                                 is_json):
    got = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        args = [a.replace("{url}", servers[name]) for a in argv]
        got[name] = _run(main, args, capsys)
    assert got["port"][0] == got["jax"][0], got
    if is_json:
        assert _json_keys(got["port"][1]) == _json_keys(got["jax"][1])


def test_metrics_json_and_the_flat_samples(servers, capsys):
    code, out = _run(cli.main, ["metrics", "--url", servers["port"],
                                "--json"], capsys)
    samples = json.loads(out)
    assert code == 0
    assert any(k.startswith("pio_http_requests_total{") for k in samples)
    assert any(k.startswith("pio_prof_samples_total") or
               k.startswith("pio_prof_effective_hz") for k in samples)


@pytest.mark.parametrize("argv", [
    ["journal", "-n", "3"], ["journal", "--json"], ["anomalies"],
    ["anomalies", "--json"], ["data", "--top", "3"], ["data", "--json"],
    ["mem"], ["mem", "--json"], ["top", "--once"],
    ["top", "--once", "--json"], ["journal", "--fleet"],
    ["data", "--fleet"], ["anomalies", "--fleet"], ["metrics"],
], ids=lambda a: " ".join(a))
def test_in_process_commands_exit_like_jax(capsys, argv):
    port_code, _ = _run(cli.main, argv, capsys)
    jax_code, _ = _run(jax_cli.main, argv, capsys)
    assert port_code == jax_code
