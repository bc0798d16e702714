"""The benchmark's shared code: finding configurations, traffic, drivers,
generators and metrics by name, the spans and the device trace of a traced
run, and the checks that keep JAX out of the measured process."""
