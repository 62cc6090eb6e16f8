"""Training and serving steps of the port: the optimizer (``optimizer``)
and the train, prefill and decode steps (``train_step``)."""
