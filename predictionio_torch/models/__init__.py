"""Algorithm library of the port (counterpart of ``predictionio_tpu.models``).

  als      — matrix factorization serving (ref: MLlib ALS templates)
             and the prepared ratings; ALS training is not ported yet
  twotower — two-tower neural retrieval, trained on the card
"""
