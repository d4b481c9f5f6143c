"""Analytic cost model of the model substrate (``perf/cost_model.py``)."""
