"""Algorithm library of the port (counterpart of ``predictionio_tpu.models``).

  als      — matrix factorization (ref: MLlib ALS templates): training
             through ops/als.py, serving, and the prepared ratings
  twotower — two-tower neural retrieval, trained on the card
"""
