"""Interval arithmetic for the serve readers: the length of merged,
sorted intervals and of the intersection of two such lists."""

from __future__ import annotations


def length(intervals):
    return sum(e - s for s, e in intervals)


def overlap(a, b):
    """Length of the intersection of two merged, sorted interval lists."""
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total
