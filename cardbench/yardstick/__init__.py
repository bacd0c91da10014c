"""The frozen yardstick: peaks, work counts, statistics and trace reading.

Nothing here imports the program under test, so a change to the program
cannot move the ruler it is measured by.
"""
