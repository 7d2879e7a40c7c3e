"""Workflow orchestration of the port (counterpart of
``predictionio_tpu.workflow``).

  deploy — model reload for serving (ref: Engine.prepareDeploy:174)
"""
