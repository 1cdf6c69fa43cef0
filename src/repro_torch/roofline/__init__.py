"""The dry run's cost model: ``op_stats`` (an op census of a traced step),
``analysis`` (the roofline's three terms in H100 terms) and
``descent_bytes`` (the serving descent's bytes)."""
