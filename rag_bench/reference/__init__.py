"""The plain reference: numpy (and plain torch for the dense scores),
importing nothing of the program."""
