"""The frozen yardstick: operation and byte counts, and the card's peaks.

Later changes to the program do not change these files: a roofline share or
a utilisation read against them means the same work on any version.
"""
