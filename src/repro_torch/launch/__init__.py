"""Launchers (port of ``repro.launch``): the serving driver ``serve`` and
the train step ``steps.make_train_step``."""
