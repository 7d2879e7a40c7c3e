"""Workflow orchestration of the port (counterpart of
``predictionio_tpu.workflow``).

  config — WorkflowParams (ref: WorkflowParams.scala:19)
  train  — train an engine, store the instance and its models
           (ref: CoreWorkflow.runTrain:42)
  deploy — model reload for serving (ref: Engine.prepareDeploy:174)
  evaluate — run an evaluation, store its EvaluationInstance
           (ref: CoreWorkflow.runEvaluation:96)
  fake   — run a function through the evaluation plumbing
           (ref: FakeWorkflow.scala)
"""
