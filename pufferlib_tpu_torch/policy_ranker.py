"""Pairwise Elo rating over policy match scores, persisted in sqlite.

The port's own copy of pufferlib_tpu/policy_ranker.py (it needs sqlite3
alone): win probability 1 / (1 + 10^((rating_b - rating_a) / scale)) with
the reference's scale of 77.6, and the ratings table in sqlite.
"""
import sqlite3


def win_prob(rating_a, rating_b, scale=77.6):
    return 1.0 / (1.0 + 10 ** ((rating_b - rating_a) / scale))


def update_elo(rating_a, rating_b, score_a, k=16.0, scale=77.6):
    """score_a: 1 win, 0.5 draw, 0 loss for player a."""
    expected = win_prob(rating_a, rating_b, scale)
    delta = k * (score_a - expected)
    return rating_a + delta, rating_b - delta


class Ranker:
    def __init__(self, db_path='ratings.sqlite', anchor='anchor',
            default_rating=1000.0, k=16.0, scale=77.6):
        self.conn = sqlite3.connect(db_path)
        self.conn.execute(
            'CREATE TABLE IF NOT EXISTS ratings ('
            'name TEXT PRIMARY KEY, rating REAL, games INTEGER)')
        self.conn.commit()
        self.default_rating = default_rating
        self.anchor = anchor
        self.k = k
        self.scale = scale

    def rating(self, name):
        row = self.conn.execute(
            'SELECT rating FROM ratings WHERE name=?', (name,)).fetchone()
        if row is None:
            self.conn.execute(
                'INSERT INTO ratings VALUES (?, ?, 0)',
                (name, self.default_rating))
            self.conn.commit()
            return self.default_rating
        return row[0]

    def ratings(self):
        return dict(self.conn.execute(
            'SELECT name, rating FROM ratings').fetchall())

    def update(self, scores):
        """scores: dict policy_name -> episode score. Every pair plays a
        pseudo-match decided by score comparison; the anchor policy (if
        present) is pinned to the default rating so the scale does not
        drift."""
        names = list(scores)
        ratings = {n: self.rating(n) for n in names}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if scores[a] == scores[b]:
                    outcome = 0.5
                else:
                    outcome = 1.0 if scores[a] > scores[b] else 0.0
                ra, rb = update_elo(ratings[a], ratings[b], outcome,
                    self.k, self.scale)
                ratings[a], ratings[b] = ra, rb

        if self.anchor in ratings:
            ratings[self.anchor] = self.default_rating

        for name, rating in ratings.items():
            self.conn.execute(
                'UPDATE ratings SET rating=?, games=games+1 WHERE name=?',
                (rating, name))
        self.conn.commit()
        return ratings

    def close(self):
        self.conn.close()
