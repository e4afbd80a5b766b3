"""Launchers: the step factories and the train and serve command lines."""
