"""HTTP serving of the port (counterpart of ``predictionio_tpu.serving``).

  http          — JSON request handler + threaded server lifecycle
  engine_server — deployed-engine query serving, port 8000
                  (ref: core/.../workflow/CreateServer.scala)
"""
