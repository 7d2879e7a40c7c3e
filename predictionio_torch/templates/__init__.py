"""Engine templates of the port (counterpart of ``predictionio_tpu.templates``).

  recommendation — ALS personal recommendations
                   (ref: examples/scala-parallel-recommendation)
"""
