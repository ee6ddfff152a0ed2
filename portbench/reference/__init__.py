"""The plain reference: the float64 arithmetic (`plain.py`), one oracle per
analysis call (`oracles/<call>.py`), and the comparison that decides
`correct` (`judge.py`)."""
