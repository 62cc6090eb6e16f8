"""Training and serving steps of the port: so far the serving steps
(``train_step``)."""
