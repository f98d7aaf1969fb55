"""System-under-test adapters: each builds the program's objects for one
kind of configuration and runs one job through its timed entry."""
