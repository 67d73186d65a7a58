"""The code a user of `neptune_tpu_torch` writes for each configuration:
the system under test, built through the port's DSL. One module per
configuration program, named by the configuration file's `program`."""
