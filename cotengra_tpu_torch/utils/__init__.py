"""Host-side helpers the port carries for itself (counterparts of
``cotengra_tpu/utils``)."""
