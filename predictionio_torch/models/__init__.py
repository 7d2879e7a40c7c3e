"""Algorithm library of the port (counterpart of ``predictionio_tpu.models``).

  als      — matrix factorization (ref: MLlib ALS templates): training
             through ops/als.py, serving, and the prepared ratings
  twotower — two-tower neural retrieval, trained on the card
  similarproduct — item-to-item similarity over implicit ALS factors
             (views and likes; ref: scala-parallel-similarproduct)
  ecommerce — explicit ALS with serve-time business rules (ref:
             scala-parallel-ecommercerecommendation)
"""
