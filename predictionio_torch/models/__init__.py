"""Algorithm library of the port (counterpart of ``predictionio_tpu.models``).

  als — matrix factorization serving (ref: MLlib ALS templates); its
        training comes with the next slice
"""
