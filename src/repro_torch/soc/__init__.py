"""SoC model: configurations, accelerator profiles, timing, applications
and the batched episode environment."""
