"""Frozen copies of the program's measuring arithmetic.

Each file names the file and commit it was copied from.  The benchmark
owns these copies: later changes to the program do not change them, so a
PR that edits the program cannot move its own yardstick.
"""
