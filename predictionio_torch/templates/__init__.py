"""Engine templates of the port (counterpart of ``predictionio_tpu.templates``).

  recommendation — ALS personal recommendations and the rate/buy event
                   read (ref: examples/scala-parallel-recommendation)
  twotower       — two-tower retrieval, and the ALS + two-tower hybrid
"""
