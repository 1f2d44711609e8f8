"""The port's command line: ``python -m classmate_rag_tpu_torch.cli``
(``main.py``)."""
