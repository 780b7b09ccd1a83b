"""The experiment driver, its model and data factories and the run
names."""
