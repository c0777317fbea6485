"""The drivers of the traffic mixes, and the program they drive."""
