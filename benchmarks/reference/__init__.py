"""The plain reference the program's answers are judged against: plain
torch on the bundle's own files, nothing of the program."""
